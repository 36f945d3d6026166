"""The port's benchmark (``ompi_tpu_torch/tools/bench.py``) on the CPU,
against the JAX package where the two compute the same thing.

- Each verb's raw PyTorch counterpart equals the verb on ``mesh_world(8,
  "cpu")``: bit for bit, but the world float SUM, within 1e-6 of the summed
  magnitudes (the two may add in other orders).
- The sweep, verb, dispatch-tax and quant rows carry ``bench.py``'s keys.
- The quant sweep's ``max_err_vs_bound`` at 64 KB a rank equals the JAX
  package's, computed as ``bench.py:176-213`` does on JAX ``mesh_world`` over
  the 8-device CPU mesh from the same ``RandomState(0)`` data: int8 to
  1e-12 (bit-exact results); fp8 within one quantization step of the block
  (``BlockCodec.quant_step``), as in ``tests/test_torch_quant.py``.
- Settings, the comm's cache and ``ring_attention`` come back after the
  legs that change them, also when a leg raises.
- The timers call what they time as often as they say, and return
  positive times on the CPU. The other tests put ``cheap_timers`` in
  their place: they check what a leg computes, not how long it takes, and
  timing loops on a loaded CPU take minutes.
- ``bench_mfu``'s parameter count and flops equal those of the JAX
  ``init_params`` tree under ``bench.py``'s formula, and its first loss
  equals JAX ``make_train_step``'s on the same weights within 2e-3
  relative (``tests/test_torch_train_step.py``'s bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ompi_tpu.mca.var import get_var, set_var
from ompi_tpu.models import transformer as jtfm
from ompi_tpu.parallel import mesh_world as jax_mesh_world
from ompi_tpu.quant import codec as jcodec
from ompi_tpu_torch import quant  # noqa: F401 registers the quant_* vars
from ompi_tpu_torch.mca.var import get_var as tget_var
from ompi_tpu_torch.models import transformer as ttfm
from ompi_tpu_torch.parallel.mesh import mesh_world
from ompi_tpu_torch.quant import codec as tcodec
from ompi_tpu_torch.tools import bench
from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture

W = 8
CPU = torch.device("cpu")
SMALL = jtfm.Config(**bench.SMALL)
TINY = ttfm.Config(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                   seq_len=64)


@pytest.fixture(scope="module")
def world():
    return mesh_world(W, "cpu")


@pytest.fixture
def cheap_timers(monkeypatch):
    """The bench's timers, each timed call made once: fixed times, and a
    short prologue loop."""

    def paired_ms(fn_a, fn_b, x, iters, rounds=3, b_arg=None):
        fn_a(x)
        fn_b(x if b_arg is None else b_arg)
        return 2.0, 1.0

    def floor_us(fn, arg, iters=60):
        fn(arg)
        return 10.0

    monkeypatch.setattr(bench, "paired_ms", paired_ms)
    monkeypatch.setattr(bench, "floor_us", floor_us)
    monkeypatch.setattr(bench, "PROLOGUE_CALLS", 100)


def test_timers_call_what_they_time():
    calls = []
    fn = lambda *a: calls.append(a)  # noqa: E731
    assert bench.time_ms(fn, iters=4, warmup=1, device="cpu") > 0
    assert len(calls) == 5
    calls.clear()
    assert bench.device_ms(fn, iters=3, rounds=2, device="cpu") > 0
    assert len(calls) == 1 + 3 * 2
    calls.clear()
    x, y = torch.ones(2), torch.zeros(2)
    ta, tb = bench.paired_ms(fn, fn, x, 3, rounds=2, b_arg=y)
    assert ta > 0 and tb > 0
    assert sum(a[0] is x for a in calls) == 1 + 3 * 2
    assert sum(a[0] is y for a in calls) == 1 + 3 * 2
    calls.clear()
    assert bench.floor_us(fn, x, iters=5) > 0 and len(calls) == 5


# verb: (the verb on the world, its raw counterpart, the input's shape, a
# world float SUM)
RAW = {
    "allreduce": (lambda w, x: w.allreduce(x), bench.raw_allreduce,
                  (W, 257), True),
    "bcast": (lambda w, x: w.bcast(x, 0), bench.raw_bcast, (W, 257), False),
    "allgather": (lambda w, x: w.allgather(x), bench.raw_allgather,
                  (W, 257), False),
    "alltoall": (lambda w, x: w.alltoall(x), bench.raw_alltoall,
                 (W, W, 33), False),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("verb", sorted(RAW))
def test_raw_counterparts_equal_the_verbs(world, verb, seed):
    call, raw, shape, sums = RAW[verb]
    x = world.shard(np.random.RandomState(seed).standard_normal(shape)
                    .astype(np.float32))
    got, want = call(world, x), raw(x)
    assert got.shape == want.shape and got.dtype == want.dtype
    if sums:
        assert bool(((got - want).abs() <= 1e-6 * x.abs().sum(0)).all())
    else:
        assert torch.equal(got, want)


def test_rows_carry_the_keys_of_bench_py(world, cheap_timers):
    sweep = bench.bench_allreduce_sweep(world, W, sizes=(1 << 10, 1 << 12))
    assert [r["bytes"] for r in sweep] == [1 << 10, 1 << 12]
    assert all(set(r) == {"bytes", "ours_gbps", "raw_gbps", "fraction"}
               and r["fraction"] > 0 for r in sweep)
    verbs = bench.bench_verbs(world, W, total_bytes=1 << 14)
    assert set(verbs) == {"bcast_16MB_total", "allgather_16MB_total",
                          "alltoall_16MB_total"}
    assert all(set(r) == {"ours_s", "raw_s", "fraction"}
               for r in verbs.values())
    tax = bench.bench_dispatch_tax(world)
    assert set(tax) == {"ours_us", "raw_us", "overhead_us", "prologue_us",
                        "verb_sweep"}
    assert set(tax["verb_sweep"]) == {"allreduce", "scan", "exscan",
                                      "gather", "scatter", "alltoall"}
    assert all(set(r) == {"us", "layer_overhead_us"}
               for r in tax["verb_sweep"].values())


def test_a_verb_that_differs_from_its_raw_counterpart_is_refused(
        world, monkeypatch, cheap_timers):
    monkeypatch.setattr(bench, "raw_bcast", lambda x, root=0: x * 2)
    with pytest.raises(RuntimeError, match="bcast"):
        bench.bench_verbs(world, W, total_bytes=1 << 14)


def _jax_quant(mode):
    """``bench.py``'s accuracy step at 64 KB a rank on JAX mesh_world:
    (the quantized row, max err / bound, the data)."""
    set_var("quant", "enable", True)
    set_var("quant", "min_bytes", 4096)
    set_var("quant", "mode", mode)
    try:
        qworld = jax_mesh_world(jax.devices()[:W],
                                axis_name=f"mpi_quant_{mode}")
        assert qworld.coll.providers.get("allreduce") == "quant"
        codec = jcodec.make_codec(get_var("quant", "mode"),
                                  get_var("quant", "bits"),
                                  get_var("quant", "block"))
        xs = (np.random.RandomState(0).randn(W, (1 << 16) // 4) * 3).astype(
            np.float32)
        res = np.asarray(qworld.allreduce(qworld.shard(jnp.asarray(xs))))[
            0].astype(np.float64)
    finally:
        set_var("quant", "enable", False)
        set_var("quant", "min_bytes", 65536)
        set_var("quant", "mode", "int8")
    err = np.abs(res - xs.astype(np.float64).sum(axis=0))
    bound = codec.error_bound(xs)
    return res, float(np.max(err / np.maximum(bound, 1e-300))), xs


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_sweep_error_ratio_equals_jax(world, mode, cheap_timers, mca):
    res, want, xs = _jax_quant(mode)
    mca.port("quant", "mode", mode)
    rows = bench.bench_quant_sweep(world, W, sizes=(1 << 16,))
    (row,) = rows
    assert set(row) == {"bytes", "fp32_s", "quant_s", "fraction",
                        "max_err_vs_bound"}
    assert row["bytes"] == 1 << 16 and want < 1
    got = row["max_err_vs_bound"]
    if mode == "int8":
        assert abs(got - want) <= 1e-12
    else:
        # results within one quantization step of JAX's move err / bound
        # by at most step / bound of some element
        codec = tcodec.make_codec(mode, tget_var("quant", "bits"),
                                  tget_var("quant", "block"))
        slack = np.max(codec.quant_step(res) / codec.error_bound(xs))
        assert abs(got - want) <= slack and got < 1


def _quant_settings():
    return tget_var("quant", "enable"), tget_var("quant", "min_bytes")


def test_quant_settings_come_back(world, monkeypatch, cheap_timers):
    saved = _quant_settings()
    bench.bench_quant_sweep(world, W, sizes=(1 << 16,))
    assert _quant_settings() == saved

    def boom(*a, **kw):
        assert _quant_settings() == (True, 4096)
        raise RuntimeError("a leg raised")

    monkeypatch.setattr(bench, "paired_ms", boom)
    with pytest.raises(RuntimeError, match="a leg raised"):
        bench.bench_quant_sweep(world, W, sizes=(1 << 16,))
    assert _quant_settings() == saved


def test_quant_sweep_on_one_rank_is_skipped():
    rows = bench.bench_quant_sweep(mesh_world(1, "cpu"), 1, sizes=(1 << 16,))
    assert rows == [{"skipped": "quant path unavailable (allreduce "
                                "provider='mesh')"}]


def _same_cache(a, b):
    return a.keys() == b.keys() and all(a[k] is b[k] for k in a)


def test_dispatch_tax_restores_the_cache(world, cheap_timers):
    bench.bench_dispatch_tax(world)
    before = dict(world._cache)
    bench.bench_dispatch_tax(world)
    assert _same_cache(world._cache, before)


def test_dispatch_tax_restores_the_cache_when_the_timed_call_raises(
        cheap_timers):
    w = mesh_world(W, "cpu")
    bench.bench_dispatch_tax(w)
    before = dict(w._cache)
    verb = w.allreduce

    def allreduce(x, *args):
        out = verb(x, *args)
        if not isinstance(out, torch.Tensor):  # the stub answered
            raise RuntimeError("the timed call raised")
        return out

    w.allreduce = allreduce
    with pytest.raises(RuntimeError, match="the timed call raised"):
        bench.bench_dispatch_tax(w)
    assert _same_cache(w._cache, before)
    assert isinstance(verb(torch.ones((W, 4))), torch.Tensor)


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                       ("cpu", None),
                                       ("NVIDIA H100 PCIe", None)])
def test_peak_for(name, peak):
    assert bench.peak_for(name) == peak


@pytest.fixture(scope="module")
def jax_small():
    """The JAX ``init_params`` tree of bench.py's small config, and the
    first loss of JAX ``make_train_step`` on bench.py's batch."""
    params = jtfm.init_params(jax.random.PRNGKey(0), SMALL)
    toks, tgts = (t.numpy() for t in bench.model_batch(SMALL, 2, CPU))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    step, place = jtfm.make_train_step(mesh, SMALL)
    loss, _ = step(*place(params, jnp.asarray(toks.astype(np.int32)),
                          jnp.asarray(tgts.astype(np.int32))))
    return jax.tree.map(np.asarray, params), float(loss)


@pytest.fixture(scope="module")
def small_run(jax_small):
    return bench.bench_mfu("cpu", params=ttfm.params_from_jax(jax_small[0],
                                                              "cpu"))


def test_bench_mfu_counts_as_jax(jax_small, small_run):
    n = sum(x.size for x in jax.tree_util.tree_leaves(jax_small[0]))
    tokens = 2 * SMALL.seq_len
    flops = 6.0 * n * tokens \
        + 12.0 * SMALL.n_layers * SMALL.seq_len * SMALL.d_model * tokens
    assert small_run["n_params"] == n
    assert round(small_run["params_M"], 1) == round(n / 1e6, 1)
    assert small_run["flops_per_step"] == flops
    assert (small_run["batch"], small_run["ksteps"]) == (2, 2)
    assert "mfu" not in small_run and small_run["peak_bytes"] is None
    assert small_run["launches"] == {"flash_fwd": 0, "flash_dq": 0,
                                     "flash_dkv": 0}
    assert set(small_run["ablations"]) >= {"full_ms", "ce_loss_ms",
                                           "attention_ms", "other_ms"}


def test_bench_mfu_first_loss_equals_jax(jax_small, small_run):
    want = jax_small[1]
    assert abs(small_run["first_loss"] - want) <= 2e-3 * abs(want)


def test_train_flops_is_bench_py_formula():
    params = ttfm.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    n = sum(p.numel() for p in ttfm.param_leaves(params))
    assert bench.train_flops(params, TINY, 10) == 10 * (
        6.0 * n + 12.0 * TINY.n_layers * TINY.seq_len * TINY.d_model)


@pytest.fixture
def spy(monkeypatch):
    """``ring_attention`` of the model, counting its calls."""
    calls = []
    real = ttfm.ring_attention

    def ring_attention(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ttfm, "ring_attention", ring_attention)
    return ring_attention, calls


def _tiny_batch():
    params = ttfm.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    return (params,) + bench.model_batch(TINY, 2, CPU)


@pytest.mark.parametrize("attn,calls", [("identity", 0), ("dense", 0),
                                        ("flash", TINY.n_layers)])
def test_ablations_replace_the_models_ring_attention(spy, attn, calls):
    fn, seen = spy
    loss = bench.chunked_ce(TINY, 2.0 * TINY.seq_len)
    value, _ = bench.make_step(TINY, loss, attn)(*_tiny_batch())
    assert bool(torch.isfinite(value))
    assert len(seen) == calls and ttfm.ring_attention is fn


def test_the_attention_patch_is_undone_when_the_step_raises(spy):
    fn, seen = spy

    def loss(p, tk, tg):
        assert ttfm.ring_attention is bench.identity_attention
        raise RuntimeError("the loss raised")

    with pytest.raises(RuntimeError, match="the loss raised"):
        bench.make_step(TINY, loss, "identity")(*_tiny_batch())
    assert ttfm.ring_attention is fn and not seen


def test_mfu_ablations_on_the_cpu_never_call_ring_attention_to_ablate(spy):
    fn, seen = spy
    params, toks, tgts = _tiny_batch()
    out = bench._mfu_ablations(TINY, 2, 1, params, toks, tgts, 1.0, CPU)
    # the sum-loss variant runs the model's attention, a warm-up and one
    # step; the identity variant none
    assert len(seen) == 2 * TINY.n_layers and ttfm.ring_attention is fn
    assert out["full_ms"] == 1e3 and all(
        v == 0 for v in out["identity_attention_launches"].values())


def test_sgd_step_updates_in_place_as_make_train_step_does():
    p1, toks, tgts = _tiny_batch()
    p2 = ttfm.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    step, _ = ttfm.make_train_step(TINY, "cpu")
    loss_a, _ = step(p1, toks, tgts)
    denom = float(2 * TINY.seq_len)
    loss_b, out = bench.make_step(TINY, bench.chunked_ce(TINY, denom))(
        p2, toks, tgts)
    assert out is p2 and float(loss_a) == float(loss_b)
    for a, b in zip(ttfm.param_leaves(p1), ttfm.param_leaves(p2)):
        assert torch.equal(a, b) and not b.requires_grad


def test_dispatch_tax_is_mirrored_into_spc(world, cheap_timers):
    """Each verb's layer overhead is the spc counter
    ``dispatch_<verb>_layer_overhead_ns`` (``bench.py:306-317``), read
    back through ``all_pvars()``, MPI_T and the info tool; a re-run
    replaces the reading."""
    import io

    from ompi_tpu_torch import mpit
    from ompi_tpu_torch.mca.var import all_pvars
    from ompi_tpu_torch.runtime import spc
    from ompi_tpu_torch.tools import info

    for _ in range(2):
        tax = bench.bench_dispatch_tax(world)
        for verb, row in tax["verb_sweep"].items():
            name = f"dispatch_{verb}_layer_overhead_ns"
            want = max(int(round(row["layer_overhead_us"] * 1000)), 0)
            assert spc.get(name) == want
            assert all_pvars()["spc_" + name].value == want
    mpit.init_thread()
    try:
        sess = mpit.PvarSession()
        h = sess.handle_alloc(mpit.pvar_get_index(
            "spc_dispatch_allreduce_layer_overhead_ns"))
        assert h.read() == spc.get("dispatch_allreduce_layer_overhead_ns")
    finally:
        mpit.finalize()
    out = io.StringIO()
    info.print_pvars(out)
    assert "spc_dispatch_scan_layer_overhead_ns" in out.getvalue()


def test_bench_rows_are_mirrored_into_the_metrics_gauges(world, cheap_timers):
    """The quant sweep and the dispatch tax write the reference's gauges
    (``bench.py:225-228, 355-360``): each gauge is its row's value, and the
    Prometheus render carries it."""
    from ompi_tpu_torch.runtime import metrics
    from tools.promexport import validate

    samplers = dict(metrics._samplers)  # the tcp btl's, put back below
    metrics.reset_for_testing()
    try:
        rows = bench.bench_quant_sweep(world, W, sizes=(1 << 16, 1 << 12))
        tax = bench.bench_dispatch_tax(world)
        for row in rows:
            assert metrics.gauge_get("bench_quant_fraction",
                                     bytes=row["bytes"]) == row["fraction"]
            assert metrics.gauge_get("bench_quant_err_vs_bound",
                                     bytes=row["bytes"]) == \
                row["max_err_vs_bound"]
        assert metrics.gauge_get("bench_prologue_us") == tax["prologue_us"]
        assert metrics.gauge_get("bench_dispatch_overhead_us") == \
            tax["overhead_us"]
        for verb, d in tax["verb_sweep"].items():
            assert metrics.gauge_get("bench_layer_overhead_us",
                                     verb=verb) == d["layer_overhead_us"]
        text = metrics.render_prometheus()
        assert validate(text) == []
        assert 'ompi_metrics_bench_quant_fraction{bytes="65536",rank="0"}' \
            in text
        assert len(metrics.snapshot()["gauges"]) == 2 * 2 + 2 + 6
    finally:
        metrics.reset_for_testing()
        metrics._samplers.update(samplers)
