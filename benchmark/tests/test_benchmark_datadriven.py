"""The harness finds a new configuration, traffic mix, cell and per-layer
metric by their names alone: in a copy of the benchmark they are added as
new files and entries, no existing file is edited, and the harness runs
them on the CPU at a tiny size."""

import hashlib
import json

import pytest

from toy_cells import ROOT, TOY_CELLS, run_toy, toy_root

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _digests(base):
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in base.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("toy"))


def test_only_new_files_and_entries(root):
    before = _digests(ROOT / "benchmark")
    after = _digests(root / "benchmark")
    assert {k: after[k] for k in before} == before
    new = {str(p) for p in set(after) - set(before)}
    assert new == {"configs/toy.json", "traffic/toy-train.json",
                   "traffic/toy-prefill.json", "limits/toy.train.json",
                   "limits/toy.prefill.json", "metrics/toy_calls.py"}
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    now = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads"):
        assert now[key][:len(old[key])] == old[key]
    assert [m["name"] for m in now["per_layer"][:len(old["per_layer"])]] \
        == [m["name"] for m in old["per_layer"]]


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_toy_cells_run_and_print_the_contract_line(root, cell, trace):
    proc = run_toy(root, cell, seed=2 ** 31 + 12345, trace=trace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS[:5] + (["breakdown"] if trace else []) + \
        ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        # the toy metric is found by name (the traced calls: a round of 8
        # requests, or 2 steps); the device readers find nothing to read off
        # the card and are left out
        assert line["metrics"] == {"toy_calls": {
            "value": 8.0 if cell == "toy.prefill" else 2.0,
            "unit": "calls"}}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    else:
        want = {"setup_s"} | ({"train_tokens_per_s"} if cell == "toy.train"
                              else {"prefill_tokens_per_s",
                                    "prefill_p95_ms"})
        assert set(line["metrics"]) == want
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


def test_the_same_seed_gives_the_same_readings(root):
    lines = [json.loads(run_toy(root, "toy.train", seed=99).stdout
                        .strip().splitlines()[-1]) for _ in range(2)]
    assert lines[0]["checks"] == lines[1]["checks"]
