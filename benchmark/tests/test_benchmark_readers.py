"""The yardstick and the per-layer readers, on the CPU, against counts worked
by hand on synthetic shapes and profiler events."""

import json

import pytest

from toy_cells import ROOT

from benchmark.lib import flops, layers, spec, trace
from benchmark.lib.weights import Dims, dims_of

OPT_1_3B = Dims(vocab=50272, d_model=2048, n_heads=32, n_layers=24,
                d_ff=8192, seq_len=2048, lr=0.01)
H100 = flops.PEAKS["NVIDIA H100 80GB HBM3"]


def test_configs_read_as_published():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    d = dims_of(json.loads((ROOT / files["opt-1.3b"]).read_text()))
    assert d == OPT_1_3B
    d = dims_of(json.loads((ROOT / files["opt-6.7b"]).read_text()))
    assert (d.d_model, d.n_heads, d.head_dim, d.d_ff, d.n_layers) == (
        4096, 32, 128, 16384, 32)


def test_matmul_parameters_by_hand():
    # 24 * (4 * 2048^2 + 2 * 2048 * 8192) block weights + 50272 * 2048
    assert flops.n_matmul(OPT_1_3B) == 1_207_959_552 + 102_957_056


def test_train_step_flops_count_causal_pairs():
    # 6 * 1,310,916,608 * 16,384 + 6 * 24 layers * 2048 d * 8 rows
    # * (2048 * 2049) visible pairs
    want = 128_868_346_232_832 + 9_900_436_488_192
    assert flops.train_flops(OPT_1_3B, 8, 2048) == want
    assert round(want / 1e12, 1) == 138.8


def test_forward_flops_are_a_third_of_a_step():
    assert flops.forward_flops(OPT_1_3B, 4, 640) * 3 == \
        flops.train_flops(OPT_1_3B, 4, 640)


def test_flash_bounds_match_the_frozen_arithmetic():
    # chip_smoke.flash_bound_ms at [8, 8, 1024, 128] bf16: 84,148,224 bytes
    # over 3.35 TB/s (25.12 us) beats 17,196,646,400 flops over 989 TF/s
    assert flops.flash_flops("flash_fwd", 8, 8, 1024, 128) == 17_196_646_400
    fwd = flops.flash_fwd_bound_s(8, 8, 1024, 128, 2, H100)
    assert fwd == pytest.approx(84_148_224 / 3.35e12, rel=1e-12)
    dq, dkv = flops.flash_bwd_bounds_s(8, 8, 1024, 128, 2, H100)
    # PERF.md's table: 0.0302 and 0.0402 ms, both bytes-bound
    assert round(dq * 1e3, 4) == 0.0302 and round(dkv * 1e3, 4) == 0.0402


def test_gemm_bound_takes_the_larger_of_ops_and_bytes():
    # a short prompt: [128, 4096] x [4096, 4096] is bytes-bound
    s = flops._gemm_s(128, 4096, 4096, H100)
    nbytes = 2 * (128 * 4096 + 4096 * 4096) + 4 * 128 * 4096
    assert s == pytest.approx(nbytes / 3.35e12)
    s = flops._gemm_s(16384, 2048, 8192, H100)
    assert s == pytest.approx(2 * 16384 * 2048 * 8192 / 989e12)
    # a training step: each product forward, dX and dW
    one = flops.gemm_bound_s(OPT_1_3B, 16384, False, H100)
    three = flops.gemm_bound_s(OPT_1_3B, 16384, True, H100)
    assert three == pytest.approx(3 * one, rel=0.05) and three > one


@pytest.mark.parametrize("name, kind", [
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64", "gemm"),
    ("cutlass3x_sm90_tensorop_s64x256x16gemm_bf16_bf16_f32", "gemm"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float>", "gemm"),
    ("flash_fwd_kernel(CUtensorMap, CUtensorMap, CUtensorMap, float*)",
     "flash"),
    ("flash_dkv_kernel", "flash"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>", "glue"),
    ("void at::native::reduce_kernel<512, 1>", "glue"),
    ("Memcpy DtoD (Device -> Device)", "glue"),
])
def test_kernel_classes(name, kind):
    assert trace.classify(name) == kind


def _traced(ops, window=(0.0, 1000.0), host=(), kind="prefill",
            work=({"batch": 1, "seq": 128},), peak=H100, rest_s=2e-3):
    return trace.Traced(window=window,
                        device_ops=[trace.Op(*o) for o in ops],
                        host_ops=[trace.Op(*o) for o in host],
                        work=list(work), rest_work=list(work) * 3,
                        rest_s=rest_s, kind=kind, dims=OPT_1_3B, peak=peak)


def test_union_busy_counts_overlap_once():
    t = _traced([("a", 0, 100), ("b", 50, 150), ("c", 300, 400),
                 ("d", 350, 360)])
    assert trace.busy_intervals(t.device_ops) == [(0, 150), (300, 400)]
    assert trace.busy_s(t) == pytest.approx(250e-6)
    assert trace.idle_gaps(t) == [(150, 300), (400, 1000)]


def test_readers_on_synthetic_events():
    ops = [("nvjet_gemm", 0, 400), ("flash_fwd_kernel", 400, 500),
           ("elementwise_kernel", 500, 600), ("elementwise_kernel", 700, 800)]
    t = _traced(ops, window=(0.0, 1000.0))
    assert layers.glue_share(t) == pytest.approx(100 * 200 / 700)
    # 700 us busy for one call; the rest ran three such calls in 3 ms
    idle = layers.device_idle(_traced(ops, rest_s=3e-3))
    assert idle == pytest.approx(100 * (1 - 3 * 700e-6 / 3e-3))
    need = flops.gemm_bound_s(OPT_1_3B, 128, False, H100)
    assert layers.gemm_roofline(t) == pytest.approx(100 * need / 400e-6)
    need = flops.flash_bound_s(OPT_1_3B, 1, 128, False, H100)
    assert layers.flash_roofline(t) == pytest.approx(100 * need / 100e-6)
    # the untraced rest of the window: three such calls in 2 ms
    mfu = 3 * flops.forward_flops(OPT_1_3B, 1, 128) / 2e-3 / 989e12
    assert layers.mfu(t) == pytest.approx(100 * mfu)


def test_training_readers_count_the_backward():
    t = _traced([("nvjet", 0, 10), ("flash_dq_kernel", 10, 20)],
                kind="train", work=[{"batch": 8, "seq": 2048}])
    assert layers.model_flops(t, t.work) == flops.train_flops(OPT_1_3B, 8,
                                                               2048)
    need = flops.flash_bound_s(OPT_1_3B, 8, 2048, True, H100)
    assert layers.flash_roofline(t) == pytest.approx(100 * need / 10e-6)


def test_readers_find_nothing_without_device_ops_or_peak():
    t = _traced([])
    for fn in (layers.mfu, layers.glue_share, layers.gemm_roofline,
               layers.flash_roofline, layers.device_idle):
        assert fn(t) is None
    t = _traced([("nvjet", 0, 10)], peak=None)
    assert layers.mfu(t) is None and layers.gemm_roofline(t) is None


def test_breakdown_names_ops_and_what_the_host_did_in_gaps():
    t = _traced([("k1", 0, 100), ("k2", 200, 300), ("k1", 300, 400)],
                window=(0.0, 500.0),
                host=[("aten::mm", 90, 260, 1), ("cudaLaunchKernel", 150, 170, 1),
                      ("aten::item", 420, 480, 2)])
    b = trace.breakdown(t)
    assert b["device_ops"] == [["k1", pytest.approx(200e-6)],
                               ["k2", pytest.approx(100e-6)]]
    # gap 100-200 (mid 150: the launch inside mm), gap 400-500 (mid 450)
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        "cudaLaunchKernel": pytest.approx(100e-6),
        "aten::item": pytest.approx(100e-6)}
    # a gap in which the host is in no traced call
    t = _traced([("k1", 0, 100), ("k2", 200, 300)], window=(0.0, 300.0),
                host=[("cudaLaunchKernel", 180, 190, 1)])
    assert trace.breakdown(t)["idle_gaps"] == [
        [trace.HOST_CODE, pytest.approx(100e-6)]]


def test_every_per_layer_metric_has_its_reader_and_back():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    files = set((ROOT / "benchmark" / "metrics").glob("*.py"))
    assert {spec.reader_path(n) for n in names} == files
    for name in names:
        assert callable(spec.reader(name))
    assert all(m["workloads"] for m in bench["per_layer"])


def test_a_metric_reads_its_own_file_before_its_stems(tmp_path):
    metrics = tmp_path / "benchmark" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "glue_share.py").write_text("def read(t):\n    return 1.0\n")
    assert spec.reader_path("glue_share.decode", tmp_path) == \
        metrics / "glue_share.py"
    (metrics / "glue_share.decode.py").write_text(
        "def read(t):\n    return 2.0\n")
    assert spec.reader("glue_share.decode", tmp_path)(None) == 2.0
    assert spec.reader("glue_share.train", tmp_path)(None) == 1.0


class _Event:
    def __init__(self, name, device_type, start, end, thread=1):
        import types
        self.name, self.device_type, self.thread = name, device_type, thread
        self.time_range = types.SimpleNamespace(start=start, end=end)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_window_runs_between_the_two_synchronisations():
    # the card's trace: device activity and runtime calls only, no
    # annotation; the window runs from the end of the first
    # cudaDeviceSynchronize to the end of the last
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    prof = _Prof([_Event("early_kernel", cuda, 0, 20),
                  _Event(trace.SYNC, cpu, 5, 30),
                  _Event("cudaLaunchKernel", cpu, 35, 40),
                  _Event("nvjet_gemm", cuda, 40, 90),
                  _Event(trace.SYNC, cpu, 45, 100)])
    t = trace.from_profiler(prof, work=[], rest_work=[], rest_s=1.0,
                            kind="prefill", dims=OPT_1_3B, peak=H100)
    assert t.window == (30, 100)
    assert [(o.name, o.start, o.end) for o in t.device_ops] == [
        ("nvjet_gemm", 40, 90)]
    assert [o.name for o in t.host_ops] == ["cudaLaunchKernel", trace.SYNC]
    with pytest.raises(RuntimeError):
        trace.from_profiler(_Prof(prof.events()[:2]), work=[], rest_work=[],
                            rest_s=1.0, kind="prefill", dims=OPT_1_3B,
                            peak=H100)
