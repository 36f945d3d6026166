"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports torch and the port only, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances: 2e-2 absolute on ``out`` and 1e-2 on ``lse`` (bf16 operands on
both sides; the kernel rounds P to bf16 against a running row max, the
plain version against the final one), and the exact sentinel on empty rows.
The backward kernels are held to their plain version at 2e-2 of each
gradient's largest magnitude: both round P and dS to bf16, but values near
a rounding boundary may round apart after the two sum in other orders, and
one bf16 ulp is 4e-3 relative. The "none" block gives exact zeros.

Then two ranks that share the card (``parallel.launch``): the facts the
shared-card transport rests on, and every verb staged through host memory,
exactly. Last, the mesh-mode communicator: ``mesh_world(8)`` on the card
against ``mesh_world(8, "cpu")``, verb by verb, through ``chip_smoke.py``'s
``comm_parity`` (bit-exact but a world float SUM, 1e-6), and the dry run at
the JAX configuration on the card against the CPU's loss (1e-5 relative),
and the comm's nonblocking and persistent verbs and the accelerator
component on the card: each i-verb returns behind queued device work with
no host sync, its request pending until the device has run it, with trace
spans on as well (phase 4i: ``chip_smoke.phase_observe`` and its child
processes, which set the MCA variables in their environments). Then the
quantized allreduce on the card against the CPU comm (one quantization
step, and the error bound of the exact sum), the mesh window (bit for bit,
and an Rput behind queued work), two slice controllers sharing the card
(``chip_smoke._slice_rank``: exact but float SUM, 1e-6) and a checkpoint
resume on the card (the losses of the run straight, within the spread of
two such runs: 0 where the step is repeatable). Last, the port's bench and
tools: ``bench_mfu`` at the flagship width and a depth of 2 launches
n_layers of each kernel a timed step and none under identity attention,
``profile_flash``'s "ours" rows launch the kernels, and every entry point
of the bench, the tools and the example raises without a card when no
device is named (that test runs on any host).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ompi_tpu_torch import entry as tentry
from ompi_tpu_torch.models import transformer as ttfm
from ompi_tpu_torch.ops import flash_attention as tfa
from ompi_tpu_torch.ops import mxu as tmxu
from ompi_tpu_torch.ops import ring_attention as tra
from ompi_tpu_torch.parallel import axes as taxes
from ompi_tpu_torch.parallel.launch import run_world
from ompi_tpu_torch.parallel.mesh import mesh_world

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

RELATIONS = {"causal": (False, True), "full": (True, False),
             "none": (False, False)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, seed, device, dtype, k_shape=None):
    """q of ``shape``; k and v of ``k_shape`` (default: the same)."""
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(device, dtype)
        for s in (shape, k_shape or shape, k_shape or shape))


# (layout, q shape, k/v shape or None for q's): five mixed cases (T = 64
# leaves a 128-row Q tile half empty), then in both layouts every head dim
# the gate admits at a small T and a ragged last tile (T = 192: the last
# 128-row tile is half past the sequence), and Tq != Tk (a short Q shard
# against a long KV shard, and a ragged Q shard against one KV tile)
CASES = ([("bthd", (2, 128, 3, 64), None), ("bhtd", (2, 3, 192, 128), None),
          ("bhtd", (2, 4, 256, 32), None), ("bthd", (1, 64, 2, 16), None),
          ("bhtd", (1, 2, 64, 128), None)]
         + [(lay, (2, 2, 128, D) if lay == "bhtd" else (2, 128, 2, D), None)
            for lay in ("bhtd", "bthd") for D in range(16, 129, 16)]
         + [(lay, (1, 3, 192, D) if lay == "bhtd" else (1, 192, 3, D), None)
            for lay in ("bhtd", "bthd") for D in (64, 80, 128)]
         + [("bhtd", (1, 2, 128, 64), (1, 2, 1024, 64)),
            ("bthd", (1, 128, 2, 64), (1, 1024, 2, 64)),
            ("bhtd", (1, 2, 192, 128), (1, 2, 64, 128))])
CASE_IDS = [f"{lay}-{'x'.join(map(str, s))}" + (
    f"-kv{'x'.join(map(str, ks))}" if ks else "") for lay, s, ks in CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout,shape,k_shape", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("relation", sorted(RELATIONS))
def test_flash_fwd_matches_plain(cuda, relation, layout, shape, k_shape,
                                 dtype):
    kf, kt = RELATIONS[relation]
    q, k, v = _qkv(shape, 0, cuda, dtype, k_shape)
    before = tfa.KERNEL_LAUNCHES
    o_k, l_k = tfa.flash_block(q, k, v, kf, kt, layout=layout)
    assert tfa.KERNEL_LAUNCHES == before + 1
    o_p, l_p = tfa.flash_block_reference(q, k, v, kf, kt, layout=layout)
    torch.cuda.synchronize()
    assert o_k.shape == q.shape and o_k.dtype == torch.float32
    if relation == "none":
        assert bool((o_k == 0).all())
        assert bool((l_k == np.float32(tfa.NEG_BIG)).all())
        return
    torch.testing.assert_close(o_k, o_p, atol=2e-2, rtol=0)
    torch.testing.assert_close(l_k, l_p, atol=1e-2, rtol=0)


@pytest.mark.cuda
def test_flash_fwd_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(1, 96, 1, 64, device=cuda)
    with pytest.raises(ValueError):
        tfa.flash_block(q, q, q, False, True)


@pytest.mark.cuda
def test_ring_attention_on_card_launches_the_kernel_or_raises(cuda):
    """On the card ring attention never runs plain attention unasked: a
    shape the kernel takes launches it, one it cannot take raises, by
    default as with ``use_flash=True``; ``use_flash=False`` asks for the
    plain path by name and launches nothing."""
    q, k, v = _qkv((1, 2, 128, 32), 3, cuda, torch.bfloat16)
    before = tfa.KERNEL_LAUNCHES
    o = tra.ring_attention(q, k, v, "sp", 1, layout="bhtd")
    assert tfa.KERNEL_LAUNCHES == before + 1
    p = tra.ring_attention(q, k, v, "sp", 1, mxu_dtype=torch.bfloat16,
                           use_flash=False, layout="bhtd")
    torch.testing.assert_close(o.float(), p.float(), atol=2e-2, rtol=2e-2)
    q, k, v = _qkv((1, 2, 96, 32), 4, cuda, torch.bfloat16)
    for use_flash in (None, True):
        with pytest.raises(ValueError):
            tra.ring_attention(q, k, v, "sp", 1, use_flash=use_flash,
                               layout="bhtd")
    before = tfa.KERNEL_LAUNCHES
    o = tra.ring_attention(q, k, v, "sp", 1, use_flash=False, layout="bhtd")
    assert tfa.KERNEL_LAUNCHES == before and o.device.type == "cuda"
    p = tra.ring_attention(q.cpu(), k.cpu(), v.cpu(), "sp", 1,
                           layout="bhtd")
    torch.testing.assert_close(o.cpu().float(), p.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_contract_f32_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.standard_normal((4, 64, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 8, 16)).astype(np.float32))
    ref = tmxu.contract_f32("btd,dhf->bhtf", x, w)
    out = tmxu.contract_f32("btd,dhf->bhtf", x.to(cuda), w.to(cuda))
    assert out.dtype == torch.float32
    torch.testing.assert_close(out.cpu(), ref, atol=1e-3, rtol=1e-4)


def _bwd_inputs(shape, layout, seed, device, dtype, kf, kt, k_shape=None):
    """q, k, v, a random output cotangent, the forward's lse and a delta
    with a non-zero lse cotangent folded in."""
    q, k, v = _qkv(shape, seed, device, dtype, k_shape)
    rng = np.random.RandomState(seed + 100)
    dout = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device)
    out, lse = tfa.flash_block_reference(q, k, v, kf, kt, layout=layout)
    g_lse = torch.from_numpy(rng.standard_normal(lse.shape).astype(
        np.float32)).to(device)
    delta = tfa.flash_delta(out.to(torch.bfloat16), dout, g_lse, layout)
    return q, k, v, dout, lse, delta


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout,shape,k_shape", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("relation", sorted(RELATIONS))
def test_flash_bwd_matches_plain(cuda, relation, layout, shape, k_shape,
                                 dtype):
    kf, kt = RELATIONS[relation]
    args = _bwd_inputs(shape, layout, 0, cuda, dtype, kf, kt, k_shape)
    dq0, dkv0 = tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES
    got = tfa.flash_block_bwd(*args, kf, kt, layout=layout)
    assert (tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == (dq0 + 1, dkv0 + 1)
    ref = tfa.flash_block_bwd_reference(*args, kf, kt, layout=layout)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        if relation == "none":
            assert bool((g == 0).all()), name
            continue
        tol = 2e-2 * float(r.abs().max())
        torch.testing.assert_close(g, r, atol=tol, rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,relation", [((2, 4, 256, 64), "causal"),
                                            ((2, 3, 192, 128), "causal"),
                                            ((2, 3, 192, 128), "full"),
                                            ((1, 2, 64, 128), "causal")])
def test_flash_bwd_is_deterministic(cuda, shape, relation):
    """One block owns each output tile, so no atomics: two runs of
    flash_dq and of flash_dkv give the same bits, ragged last tile
    included."""
    kf, kt = RELATIONS[relation]
    args = _bwd_inputs(shape, "bhtd", 5, cuda, torch.bfloat16, kf, kt)
    sm = shape[-1] ** -0.5
    dq = [tfa.flash_dq(*args, kf, kt, sm, "bhtd") for _ in range(2)]
    assert torch.equal(dq[0], dq[1]), "dq"
    a = tfa.flash_block_bwd(*args, kf, kt, sm, layout="bhtd")
    b = tfa.flash_block_bwd(*args, kf, kt, sm, layout="bhtd")
    assert torch.equal(a[0], dq[0]), "dq through flash_block_bwd"
    for name, x, y in zip(("dq", "dk", "dv"), a, b):
        assert torch.equal(x, y), name


@pytest.mark.cuda
def test_ring_attention_grad_on_card_launches_all_kernels(cuda):
    q, k, v = (x.requires_grad_() for x in _qkv((1, 2, 128, 32), 6, cuda,
                                                 torch.bfloat16))
    before = (tfa.KERNEL_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    o = tra.ring_attention(q, k, v, "sp", 1, layout="bhtd")
    o.float().square().sum().backward()
    after = (tfa.KERNEL_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    assert tuple(b + 1 for b in before) == after
    for x in (q, k, v):
        assert x.grad is not None and x.grad.dtype == torch.bfloat16
        assert bool(torch.isfinite(x.grad.float()).all())


@pytest.mark.cuda
def test_train_step_on_card_launches_each_kernel_per_layer(cuda):
    cfg = ttfm.Config(vocab=128, d_model=128, n_heads=2, n_layers=2,
                      d_ff=256, seq_len=128)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, size=(2, cfg.seq_len))
    step, place = ttfm.make_train_step(cfg, cuda)
    params, toks, tgts = place(params, toks, np.roll(toks, -1, axis=1))
    before = (tfa.KERNEL_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    loss, params = step(params, toks, tgts)
    after = (tfa.KERNEL_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == (cfg.n_layers,) * 3
    assert bool(torch.isfinite(loss))


@pytest.mark.cuda
def test_contract_f32_grads_on_card_match_cpu(cuda):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.standard_normal((4, 64, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 8, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 8, 64, 16)).astype(
        np.float32))
    grads = []
    for dev in ("cpu", cuda):
        xd, wd = (t.detach().to(dev).requires_grad_() for t in (x, w))
        tmxu.contract_f32("btd,dhf->bhtf", xd, wd).backward(g.to(dev))
        grads.append((xd.grad.cpu(), wd.grad.cpu()))
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=2e-2, rtol=1e-2)


# ---------------------------------------------- two ranks sharing the card


def _rank_gloo_p2p():
    """A point-to-point exchange of CUDA tensors over the gloo world."""
    r = dist.get_rank()
    x = torch.full((4,), float(r), device="cuda")
    ops = [dist.P2POp(dist.isend, x, 1 - r),
           dist.P2POp(dist.irecv, torch.empty_like(x), 1 - r)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    torch.cuda.synchronize()
    return True


def _rank_nccl():
    """An allreduce of a CUDA tensor over an nccl group of both ranks."""
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x, group=dist.new_group([0, 1], backend="nccl"))
    torch.cuda.synchronize()
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("probe", [_rank_gloo_p2p, _rank_nccl],
                         ids=["gloo-p2p", "nccl"])
def test_ranks_sharing_the_card_cannot_use(cuda, probe):
    """What the shared-card transport rests on: gloo moves no CUDA tensor
    point to point (a rank raises or aborts), and NCCL takes no two ranks
    on one device. So such a world is gloo and stages through the host."""
    with pytest.raises(RuntimeError):
        run_world(probe, 2, "cuda", timeout=120.0)


def _rank_verbs():
    """Every verb over "dp" on this rank's CUDA tensor, whose sums are
    exact in f32."""
    dev = taxes.current_mesh().device
    x = torch.arange(8.0, device=dev).reshape(4, 2) + 10 * taxes.rank("dp")
    out = {"allreduce": taxes.allreduce(x, "dp"),
           "max": taxes.allreduce(x, "dp", "max"),
           "reduce_scatter": taxes.reduce_scatter(x, "dp", 0),
           "reduce_scatter_untiled": taxes.reduce_scatter(x[:, :2], "dp", 1,
                                                          tiled=False),
           "allgather": taxes.allgather(x, "dp", 1),
           "alltoall": taxes.alltoall(x, "dp", 0, 1),
           "bcast": taxes.bcast(x, "dp", 1),
           "shift": taxes.shift(x, "dp")}
    assert all(y.device == x.device for y in out.values())
    mesh = taxes.current_mesh()
    return mesh.backend, mesh.staged, {k: y.cpu().numpy()
                                       for k, y in out.items()}


@pytest.mark.cuda
def test_staged_verbs_on_the_card_are_exact(cuda):
    """Two ranks sharing the card get a gloo world staged through host
    memory, and every verb gives exactly the sums and moves it should."""
    ranks = run_world(_rank_verbs, 2, "cuda", timeout=180.0)
    xs = [np.arange(8.0, dtype=np.float32).reshape(4, 2) + 10 * r
          for r in range(2)]
    total = xs[0] + xs[1]
    for r, (backend, staged, got) in enumerate(ranks):
        assert backend == "gloo" and staged
        want = {"allreduce": total, "max": xs[1],
                "reduce_scatter": total[2 * r:2 * r + 2],
                "reduce_scatter_untiled": total[:, r],
                "allgather": np.concatenate(xs, 1),
                "alltoall": np.concatenate(
                    [x[2 * r:2 * r + 2] for x in xs], 1),
                "bcast": xs[1], "shift": xs[1 - r]}
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("verb", cs.COMM_VERBS)
def test_mesh_comm_on_the_card_matches_the_cpu(cuda, verb):
    """Every call of the verb on the world, the Splits (recursive doubling,
    the non-uniform ring, UNDEFINED colours), Create_group and the carts,
    for every op and payload: the card's results equal the CPU's."""
    values, _ = cs.comm_parity(mesh_world(8, "cpu"), mesh_world(8),
                               (verb,))
    assert values > 0


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card_at_the_jax_configuration(cuda):
    """Fault C.1 repaired: the JAX dry run's model (head dim 4, which the
    kernels refuse) runs on the card through the plain attention path it
    asks for by name, and gives the CPU's loss."""
    card = tentry.dryrun_multichip(8)
    cpu = tentry.dryrun_multichip(8, "cpu")
    assert np.isfinite(card) and abs(card - cpu) <= 1e-5 * abs(cpu)


I_VERBS = {"allreduce": (), "bcast": (1,), "reduce": (None, 1),
           "allgather": (), "alltoall": (), "reduce_scatter": ()}


@pytest.mark.cuda
@pytest.mark.parametrize("verb", sorted(I_VERBS))
def test_i_verb_on_the_card_returns_before_the_device_runs_it(cuda, verb):
    """Behind 30 ms of queued sleep the i-verb returns at once, with no
    host sync in its callable (``set_sync_debug_mode("error")`` raises on
    one), and its request is pending until the device has run it; the
    result then equals the CPU comm's (a world float SUM within 1e-6 of
    the summed magnitudes)."""
    from ompi_tpu_torch.core.op import SUM

    cpu, dev = mesh_world(8, "cpu"), mesh_world(8)
    x = torch.randn((8, 8, 1 << 14), generator=torch.Generator()
                    .manual_seed(3))
    if verb in ("allreduce", "bcast", "reduce", "allgather"):
        x = x.reshape(8, -1)
    args = tuple(SUM if a is None else a for a in I_VERBS[verb])
    want = getattr(cpu, verb)(x, *args)
    ifn = getattr(dev, "i" + verb)
    ifn(x.cuda(), *args).Wait()  # the callable is built and cached
    x_d = x.cuda()
    cycles = cs._sleep_cycles(30.0)
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    torch.cuda.set_sync_debug_mode("error")
    try:
        req = ifn(x_d, *args)
        pending = not req.Test()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pending
    req.Wait()
    assert req.Test()
    got = req.result.cpu()
    if verb in ("allreduce", "reduce", "reduce_scatter"):
        assert bool(((got - want).abs() <= 1e-6 * x.abs().sum(0)).all())
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("verb", sorted(I_VERBS))
def test_traced_i_verb_on_the_card_adds_no_host_sync(cuda, verb):
    """The same with trace spans on: a span times the host's dispatch and
    never waits for the card."""
    from ompi_tpu_torch.mca.var import set_var
    from ompi_tpu_torch.runtime import trace

    set_var("trace", "enable", True)
    try:
        test_i_verb_on_the_card_returns_before_the_device_runs_it(cuda, verb)
        assert trace.buffered_events() > 0
    finally:
        set_var("trace", "enable", False)
        trace.reset()


@pytest.mark.cuda
def test_persistent_verbs_on_the_card(cuda):
    """allreduce_init freezes its callable; Starts on fresh operands equal
    the verb; a donated Start leaves the result in its operand."""
    from ompi_tpu_torch.mca.var import set_var

    dev = mesh_world(8)
    x0 = torch.randn((8, 4096), device="cuda")
    req = dev.allreduce_init(x0)
    assert req._frozen
    for _ in range(3):
        x = torch.randn((8, 4096), device="cuda")
        req.Start(x)
        req.Wait()
        assert torch.equal(req.result, dev.allreduce(x))
    set_var("coll_persist", "donate", 1)
    try:
        req = dev.allreduce_init(x0)
    finally:
        set_var("coll_persist", "donate", 0)
    x = torch.randn((8, 4096), device="cuda")
    want = dev.allreduce(x)
    req.Start(x)
    req.Wait()
    assert req.result.data_ptr() == x.data_ptr()
    assert torch.equal(req.result, want)


@pytest.mark.cuda
def test_accelerator_on_the_card_selects_cuda(cuda):
    from ompi_tpu_torch.accelerator import base, get_module
    from ompi_tpu_torch.runtime.topology import accelerators

    base._reset_selection()
    mod = get_module()
    assert mod.NAME == "cuda" and mod.num_devices() >= 1
    t = torch.randn((64, 33), device="cuda").bfloat16()
    assert mod.check_addr(t) and not mod.check_addr(t.cpu())
    back = mod.open_ipc_handle(mod.get_ipc_handle(t))
    assert back.is_cuda and torch.equal(back, t)
    assert mod.get_device(t) == t.device.index
    assert mod.device_can_access_peer(0, 0)
    assert mod.get_mem_bw() > 0
    buf = mod.mem_alloc(1 << 20)
    assert mod.check_addr(buf) and buf.numel() == 1 << 20
    mod.mem_release(buf)
    assert [d["kind"] for d in accelerators()] == [
        torch.cuda.get_device_name(i)
        for i in range(torch.cuda.device_count())]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_allreduce_on_the_card_matches_the_cpu(cuda, mode):
    """A quant-selected mesh_world(8) on the card: the eligible call is
    quantized (counted), every row equal, within one quantization step of
    the CPU comm's result and within the error bound of the exact sum;
    allreduce_init and iallreduce run the same body; reduce stays exact."""
    from ompi_tpu_torch import quant
    from ompi_tpu_torch.mca.var import set_var

    set_var("quant", "enable", True)
    set_var("quant", "mode", mode)
    try:
        cpu, dev = mesh_world(8, "cpu"), mesh_world(8)
    finally:
        set_var("quant", "enable", False)
        set_var("quant", "mode", "int8")
    assert dev.coll.providers["allreduce"] == "quant"
    codec = dev._quant_state.codec
    x = torch.randn((8, 1 << 16), generator=torch.Generator().manual_seed(2))
    x[0, 5], x[3, 700] = float("inf"), float("nan")
    quant.reset_counters()
    got = dev.allreduce(x.cuda())
    assert quant.counters()["colls"] == 1
    assert bool((got.nan_to_num() == got[:1].nan_to_num()).all())
    cs.quant_gate(got[0].cpu(), cpu.allreduce(x)[0], codec, mode)
    bound = codec.error_bound(x.numpy())
    err = (got[0].cpu().double() - x.double().sum(0)).abs().numpy()
    fin = np.isfinite(bound)
    assert np.all(err[fin] <= bound[fin])
    req = dev.allreduce_init(x.cuda())
    req.Start()
    req.Wait()
    ireq = dev.iallreduce(x.cuda())
    ireq.Wait()
    for r in (req, ireq):
        assert torch.equal(r.result.nan_to_num(), got.nan_to_num())
    y = torch.randn((8, 1 << 16), device="cuda")
    assert torch.equal(dev.reduce(y), mesh_world(8).allreduce(y))


@pytest.mark.cuda
def test_observe_phase_on_the_card(cuda):
    """``chip_smoke.py`` phase 4i: the sequence traced and untraced
    bit-equal, spc counts equal to the calls, the MPI_T cache pvars equal
    to the stats, the span tree equal to the CPU comm's, the traced i-verbs
    of 4f with no host sync, the children's variables, the dispatch tax
    off and on."""
    cs.phase_observe(torch.cuda.get_device_name(0))


@pytest.mark.cuda
def test_env_variables_select_in_child_processes(cuda):
    """quant_enable=1 with coll_persist_enable=0 and cuda_mem_bw=1234; and
    coll=^quant; accelerator=^cuda selects null; accelerator=nosuch
    raises; the card's tensors stay on the card."""
    import os
    import subprocess
    import sys

    children = {name: subprocess.Popen(
        [sys.executable, cs.__file__, "--child", name],
        env=dict(os.environ, **env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, env in cs.OBS_CHILDREN.items()}
    cs._obs_children(children, "the card")


@pytest.mark.cuda
def test_mesh_window_on_the_card(cuda):
    """The window's epochs on the card against the CPU window, bit for bit;
    an Rput behind queued device work returns with Test() False, and a
    Fetch_and_op with a Python operand syncs nothing."""
    from ompi_tpu_torch.core.op import MAX
    from ompi_tpu_torch.osc.window import MeshWin

    wins = MeshWin(mesh_world(8, "cpu"), (4096,)), MeshWin(mesh_world(8),
                                                           (4096,))
    rows = [torch.randn(4096) for _ in range(2)]
    for win, on in zip(wins, (lambda t: t, lambda t: t.cuda())):
        win.Fence()
        win.Put(on(rows[0]), 3)
        win.Accumulate(on(rows[1]), 3, MAX)
        win.Accumulate(on(rows[1]), 6)
        win.Fence()
    assert torch.equal(wins[1].array.cpu(), wins[0].array)
    win, row = wins[1], rows[0].cuda()
    win.Lock(1)
    cycles = cs._sleep_cycles(30.0)
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    torch.cuda.set_sync_debug_mode("error")
    try:
        req = win.Rput(row, 1)
        pending = not req.Test()
        old = win.Fetch_and_op(1.0, 1, 2)  # no host copy of the operand
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pending
    req.Wait()
    win.Unlock(1)
    assert float(old) == float(row[2])
    row[2] += 1.0
    assert torch.equal(win.array[1], row)


def _slice_rank(nbytes, seed):
    # the ranks import this module by name: chip_smoke's own is not one
    return cs._slice_rank(nbytes, seed)


@pytest.mark.cuda
def test_multislice_on_the_card_matches_the_flat_verbs(cuda):
    """Two slice controllers sharing the card (chip_smoke's phase 4g world
    at 64 KB a rank): every verb and i-verb against the flat CPU verb."""
    ranks = run_world(_slice_rank, cs.SLICES, "cuda", 1 << 16, 5,
                      timeout=300)
    assert all(not rk["fails"] for rk in ranks), [rk["fails"] for rk in ranks]


@pytest.mark.cuda
def test_checkpoint_resume_on_the_card(cuda, tmp_path):
    """3 steps, save, restore into fresh tensors on the card, 2 steps: the
    losses of 5 steps straight, and the restored tensors equal the saved."""
    from ompi_tpu_torch.runtime.checkpoint import MeshCheckpointer

    cfg = ttfm.Config(vocab=512, d_model=128, n_heads=2, n_layers=2,
                      d_ff=256, seq_len=128)
    toks = np.random.RandomState(4).randint(0, cfg.vocab, size=(2, 128))
    step, place = ttfm.make_train_step(cfg, "cuda")

    def fresh():
        return place(ttfm.init_params(cfg, torch.Generator().manual_seed(0),
                                      "cuda"), toks, np.roll(toks, -1, 1))

    runs = []
    for _ in range(2):
        p, t, g = fresh()
        runs.append([float(step(p, t, g)[0]) for _ in range(5)])
    spread = max(abs(a - b) for a, b in zip(*runs))
    p, t, g = fresh()
    first = [float(step(p, t, g)[0]) for _ in range(3)]
    ck = MeshCheckpointer(str(tmp_path / "ck"))
    ck.save(3, p)
    back = ck.restore(specs=ttfm.param_specs(cfg))
    for a, b in zip(ttfm.param_leaves(p), ttfm.param_leaves(back)):
        assert b.is_cuda and b.data_ptr() != a.data_ptr()
        assert torch.equal(a, b)
    resumed = [float(step(back, t, g)[0]) for _ in range(2)]
    assert max(abs(a - b) for a, b in zip(first + resumed, runs[0])) \
        <= spread


@pytest.mark.cuda
def test_bench_model_step_on_the_card_launches_each_kernel(cuda):
    """bench_mfu at the flagship width and a depth of 2: n_layers launches
    of each kernel a timed full step, none under identity attention."""
    from ompi_tpu_torch.tools import bench

    cfg = ttfm.Config(**dict(bench.FLAGSHIP, n_layers=2))
    before = bench.launch_counts()
    out = bench.bench_mfu(cuda, cfg=cfg, batch=2, ksteps=2)
    after = bench.launch_counts()
    assert out["launches"] == {n: 2 * cfg.n_layers for n in before}
    assert all(v == 0 for v in
               out["ablations"]["identity_attention_launches"].values())
    # the full step and the sum-loss ablation: a warm-up and 2 steps each
    assert {n: after[n] - before[n] for n in before} == {
        n: 2 * 3 * cfg.n_layers for n in before}
    assert np.isfinite(out["first_loss"]) and out["peak_bytes"] > 0


@pytest.mark.cuda
def test_profile_flash_ours_rows_launch_the_kernels(cuda):
    from ompi_tpu_torch.tools import profile_flash

    rows = profile_flash.main(cuda, shape=(2, 4, 256, 64), reps=2)
    assert rows["ours flash fwd"]["launches"]["flash_fwd"] > 0
    assert min(rows["ours flash fwd+bwd"]["launches"].values()) > 0
    assert rows["sdpa fwd (library)"]["launches"] == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


# entry point of the bench, the tools and the example: (its module, the
# call a user makes with no device named)
ENTRY_POINTS = {
    "bench.main": ("ompi_tpu_torch.tools.bench", lambda m: m.main([])),
    "bench.bench_mfu": ("ompi_tpu_torch.tools.bench",
                        lambda m: m.bench_mfu()),
    "profile_flash.main": ("ompi_tpu_torch.tools.profile_flash",
                           lambda m: m.main()),
    "profile_mfu.main": ("ompi_tpu_torch.tools.profile_mfu",
                         lambda m: m.main()),
    "attn_probe.main": ("ompi_tpu_torch.tools.attn_probe",
                        lambda m: m.main()),
    "mesh_allreduce.main": ("ompi_tpu_torch.examples.mesh_allreduce",
                            lambda m: m.main([])),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_bench_and_tools_raise_without_a_card(name, monkeypatch):
    """With no device named, each entry point resolves to the card, and
    raises where there is none (here made so on any host)."""
    module, call = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(importlib.import_module(module))
