#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ompi_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # and where the forward's time goes

Phases, each of which ends the run with a non-zero exit if it fails:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from ``ompi_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card: first the
   smallest shapes, (1, 1, 64 or 128, D) for every head dim, then the
   shapes the model gives it, with times for the kernel, the plain
   version, the PyTorch library call for the same function, the card's
   bound, the achieved TF/s and the share of the bound: ``flash_fwd``,
   then ``flash_dq`` and ``flash_dkv`` with a random output cotangent and
   a non-zero lse cotangent; then both again at the shapes one rank of
   the mesh phase (4c) gives them;
4. the main paths, at the flagship width (vocab 32768, d_model 1024,
   8 heads, 8 layers, d_ff 4096, seq 1024, batch 8, random weights and
   tokens from a seed), each with the kernel launch counts set to 0 just
   before it and read just after:
   - serving: the forward answering 3 requests, its logits held against
     the same forward on the plain attention path; then
     ``ompi_tpu_torch.entry`` on the card, held the same way;
   - training: the first step's loss and every gradient held against the
     plain attention path from the same parameters, then one warm-up step
     and 3 timed steps of ``make_train_step`` (forward, backward, SGD);
4c. the multi-rank path ("mesh"), at the flagship width with 2 layers, as
   worlds of processes that share the one card (``parallel.launch``); the
   kernels run on the card, the collectives over gloo through host memory
   (the transport is printed):
   - ring attention alone at sp = 2 and sp = 4, causal [8, 8, 1024, 128]
     bf16 'bhtd' with a random output cotangent: the gathered output, dq,
     dk and dv against one ``flash_block`` of the whole sequence;
   - the training step at (dp, sp, tp) = (2, 2, 2), 8 ranks, global batch
     4: the first step's loss and every gradient (allreduced over
     ("dp", "sp"), gathered over tp) against the single-rank
     ``loss_and_grads`` on the same weights and batch, then two steps, the
     second with a lower loss;
   - on every rank, with the counts reset before it, each flash kernel
     launched sp times for the ring and sp * n_layers times for a step;
4d. the mesh-mode communicator ("comm"), in this process:
   ``mesh_world(8)`` on the card against ``mesh_world(8, "cpu")``, every
   verb on the world, Split(r % 2), the non-uniform Split, a Split with
   UNDEFINED colours, Create_group([0, 2, 5]) and a 2x4 cart (periodic,
   open, and its Sub), with f32, int32 and bool payloads and SUM, PROD,
   MAX, MIN, LAND, LOR, BAND, MINLOC/MAXLOC and a user op: bit-exact but a
   world float SUM (1e-6); the number of value checks, and apart from it
   the number of calls both comms refuse with one error class, is printed.
   Then device ms, the host us of a call (through the verb, and of the
   cached callable alone) and the memory bound of: the f32 SUM
   allreduce at 1 KB to 64 MB a rank, at 64 MB on Split(r % 2) and the
   non-uniform Split; bcast, allgather and alltoall at 16 MB total;
4e. ``dryrun_multichip(8)`` at the JAX configuration on the card (the
   kernels refuse its head dim of 4, so it asks for the plain attention
   path by name)
   against the same dry run on the CPU, within 1e-5 relative;
4f. the comm's nonblocking, persistent and partitioned verbs, its reshard
   and the accelerator component, in this process (``mesh_world(8)`` on the
   card against ``mesh_world(8, "cpu")``): each of the six i-verbs at 64 MB
   a rank, f32, against the CPU verb (bit-exact but a world float SUM,
   1e-6) and the card's blocking verb, then again behind a queued
   ``torch.cuda._sleep`` of 50 ms under ``set_sync_debug_mode("error")``:
   the call returns before the sleep ends, with no host sync, and
   ``Test()`` is False; ``Request.Waitall`` over three i-verbs;
   ``allreduce_init``'s 20 Starts on fresh operands bit-exact to the verb,
   a Start's host us beside the verb's, a double Start refused, a donated
   Start writing into its operand; a ring shift of [8, 16, 2^20] f32 in 1,
   4 and 16 partitions bit-exact to one permute; the four reshard
   lowerings of a global [8192, 8192] f32 array against the CPU; device ms
   of each against its bytes bound; the accelerator selecting ``cuda``, a
   256 MiB H2D/D2H round trip, a bf16 IPC round trip and a 1 GiB device
   copy beside ``get_mem_bw``;
4g. the quantized allreduce, the mesh window, the multi-slice comm and the
   checkpointer:
   - ``mesh_world(8)`` on the card with ``quant_enable`` set, int8 and
     fp8, at 1 MB and 64 MB a rank (f32, seed 0), against the CPU comm:
     the eligible call counted as quantized, every row equal, within one
     quantization step of the CPU's result, within the codec's error bound
     of the exact sum, ``allreduce_init``'s Start equal to the verb, a
     counted wire ratio of at least 3.5; device ms and host us beside the
     plain allreduce's (in turns) and its bound;
   - a [8, 2^24] f32 ``MeshWin`` on the card against one on the CPU under
     fence, PSCW and lock epochs, bit for bit; RMA outside an epoch
     refused (``ERR_WIN``); an Rput behind 50 ms of queued sleep returning
     with ``Test()`` False; device ms of Put and Accumulate of a 64 MB row
     against their bounds, host us of ``Fetch_and_op``;
   - 2 slice controllers sharing the card (``run_world``), each a
     ``MeshComm(4)``: every verb and i-verb at 16 MB a rank against
     ``mesh_world(8, "cpu")``'s flat verb (bit-exact but float SUM, 1e-6),
     wall ms, and the allreduce's hops (the staged bridge's share);
   - the flagship trained 5 steps straight twice (the card's spread), then
     3 steps, a checkpoint saved and restored into fresh tensors on the
     card, and 2 steps: the losses of the straight run within that spread,
     the checkpoint's bytes and the save and restore wall ms, with the
     kernel launch counts reset before the resumed run and read after;
4h. the port's benchmark and tools (``ompi_tpu_torch/tools``) at their own
   sizes, in this process: ``bench``'s allreduce sweep (1 KB to 64 MB a
   rank), bcast, allgather and alltoall at 16 MB in total, each verb's
   result against its raw PyTorch counterpart's (bit-exact but the world
   float SUM, 1e-6), the dispatch tax, the quantized-allreduce sweep (64 KB
   to 16 MB a rank, within the codec's bound); ``bench_mfu`` at the
   flagship, batch 36, a warm-up and 12 timed steps, with its ablations,
   the kernel launch counts reset before it and read after (12 * n_layers
   of each kernel in the timed full steps, none under identity attention);
   ``profile_flash`` (16 calls a round, 3 rounds a row; the "ours" rows
   launch the kernels), ``profile_mfu`` (8 steps a variant) and
   ``attn_probe`` (8 calls or steps a probe) once each; the
   ``mesh_allreduce`` example on the card with and without ``--quant``, its
   lines against the same example on the CPU;
4i. the MCA variable and MPI_T layer (``phase_observe``): on
   ``mesh_world(8)``, the allreduce at 1 KB to 64 MB a rank, bcast,
   allgather and alltoall at 16 MB in total, two persistent Starts and an
   i-verb, run with ``trace_enable`` off and then on: the results
   bit-equal, the spc counts equal to the calls, the cache pvars read
   through an MPI_T session equal to ``coll/mesh.py``'s stats, the
   exported span tree equal to the same sequence's on a CPU comm; the
   i-verbs of 4f traced under ``set_sync_debug_mode("error")``; four child
   processes (``--child NAME``) whose environments set ``quant_enable``,
   ``coll_persist_enable``, ``accelerator_cuda_mem_bw``, ``coll`` and
   ``accelerator``, each held to what its variables select; the dispatch
   tax with tracing off and on;
5. with ``--profile``: the flagship forward and one training step under
   ``torch.profiler``, the device time of the 20 largest kernels and of
   every flash kernel, and the device's busy share;
6. one JSON line describing every kernel, then the device JSON line last.

Without a CUDA device, or outside a checkout, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ompi_tpu_torch.tools.bench import (PEAK_BF16_FLOPS, PEAK_BYTES, host_ms,
                                        launch_counts, time_ms, train_flops)

FLAGSHIP = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
                seq_len=1024)
BATCH = 8
REQUESTS = 3
STEPS = 3
RELATIONS = {"causal": (False, True), "full": (True, False),
             "none": (False, False)}
OUT_TOL, LSE_TOL, LOGITS_TOL = 2e-2, 1e-2, 5e-2
# backward kernels against their plain version: both round P and dS to
# bf16, but a value near a rounding boundary may round apart after the two
# sum in other orders (one bf16 ulp is 4e-3 relative), so 2e-2 of each
# gradient's largest magnitude
GRAD_TOL = 2e-2
# training step against the plain attention path: flash_fwd rounds P to
# bf16 against a running row max (as the TPU kernel does), the plain path
# against the final one, which moves the activations by about one bf16 ulp.
# At random init each gradient is a sum over the batch's 8192 tokens whose
# terms largely cancel, so that shows as up to 4.9e-2 relative L2 error at
# the flagship width (H100), as large on the tensors that no attention
# backward reaches as on the others; the loss moves by about 2e-6. 1e-1
# keeps a factor 2 over that; a wrong backward gives errors of order 1.
LOSS_RTOL, GRAD_RL2 = 1e-3, 1e-1


def require(cond: bool, what: str) -> None:
    if not cond:
        print(f"chip_smoke: FAILED: {what}", file=sys.stderr, flush=True)
        sys.exit(1)


def qkv(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype) for _ in range(3))


def check_flash(fa, shape, layout, dtype, seed):
    """Kernel against plain version for the three relations; returns the
    largest errors on out and on the lse of attended rows."""
    q, k, v = qkv(shape, seed, dtype)
    errs = []
    for rel, (kf, kt) in RELATIONS.items():
        o_k, l_k = fa.flash_block(q, k, v, kf, kt, layout=layout)
        o_p, l_p = fa.flash_block_reference(q, k, v, kf, kt, layout=layout)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(o_k).all()), f"flash_fwd {rel} finite")
        if rel == "none":
            require(bool((o_k == 0).all()) and bool(
                (l_k == np.float32(fa.NEG_BIG)).all()),
                f"flash_fwd none block: out 0, lse -1e30 ({layout})")
            continue
        e_out = float((o_k - o_p).abs().max())
        e_lse = float((l_k - l_p).abs().max())
        print(f"flash_fwd {rel:6s} {layout} {tuple(shape)} {dtype}: "
              f"max|out err| {e_out:.3e}  max|lse err| {e_lse:.3e}",
              flush=True)
        require(e_out <= OUT_TOL and e_lse <= LSE_TOL,
                f"flash_fwd {rel} {layout} within {OUT_TOL}/{LSE_TOL}")
        errs.append(e_out)
    return max(errs)


# flops per visible (q, k) pair, in units of the head dim: the forward's
# two products (S, P.V); flash_dq's three (S, dP, dS.K); flash_dkv's four
# (S^T, dP^T, P^T.dO, dS^T.Q)
FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}
# the hand-written kernel's design, as each entry of the kernels line says
DESIGN = {"flash_fwd": "wgmma+tma", "flash_dq": "wgmma+tma",
          "flash_dkv": "wgmma+tma"}


def kernel_flops(name, B, H, T, D):
    """Flops of kernel ``name`` on the causal block: its products over the
    B*H*T*(T+1)/2 visible pairs."""
    return FLOPS_PER_PAIR[name] * D * B * H * T * (T + 1) / 2


def flash_bound_ms(B, H, T, D, in_bytes):
    """Least time for the causal block: q/k/v read once, f32 out and lse
    written once; flops of the two products over the visible pairs."""
    nbytes = 3 * B * H * T * D * in_bytes + B * H * T * (D + 1) * 4
    return _bound(kernel_flops("flash_fwd", B, H, T, D), nbytes)


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def flash_bwd_bounds_ms(B, H, T, D, in_bytes):
    """Least times of flash_dq and flash_dkv for the causal block: q, k, v
    (``in_bytes`` each) and dO (bf16) read once, lse and delta read once,
    the f32 gradients written once; 6*D flops per visible pair for dq
    (S, dP, dS.K), 8*D for dk/dv (S, dP, P^T.dO, dS^T.Q)."""
    reads = B * H * T * (3 * D * in_bytes + 2 * D + 2 * 4)
    grad = B * H * T * D * 4
    return (_bound(kernel_flops("flash_dq", B, H, T, D), reads + grad),
            _bound(kernel_flops("flash_dkv", B, H, T, D), reads + 2 * grad))


def rates(name, B, H, T, D, ms, bound_ms):
    """Achieved TF/s of kernel ``name`` at ``ms`` on the causal block, and
    its share of the bound (bound_ms / ms)."""
    return kernel_flops(name, B, H, T, D) / (ms * 1e-3) / 1e12, bound_ms / ms


def bwd_inputs(fa, shape, layout, dtype, seed, kf, kt):
    """q, k, v, a random output cotangent (bf16), the forward's lse, and
    delta with a random, non-zero lse cotangent folded in."""
    q, k, v = qkv(shape, seed, dtype)
    rng = np.random.RandomState(seed + 100)
    dout = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", torch.bfloat16)
    out, lse = fa.flash_block_reference(q, k, v, kf, kt, layout=layout)
    g_lse = torch.from_numpy(rng.standard_normal(tuple(lse.shape)).astype(
        np.float32)).to("cuda")
    delta = fa.flash_delta(out.to(torch.bfloat16), dout, g_lse, layout)
    return q, k, v, dout, lse, delta


def check_flash_bwd(fa, shape, layout, dtype, seed):
    """flash_dq and flash_dkv against their plain version for the three
    relations; returns the largest abs errors of dq and of dk/dv."""
    err_dq, err_dkv = 0.0, 0.0
    for rel, (kf, kt) in RELATIONS.items():
        args = bwd_inputs(fa, shape, layout, dtype, seed, kf, kt)
        got = fa.flash_block_bwd(*args, kf, kt, layout=layout)
        ref = fa.flash_block_bwd_reference(*args, kf, kt, layout=layout)
        torch.cuda.synchronize()
        errs = []
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            require(bool(torch.isfinite(g).all()), f"flash {name} finite")
            if rel == "none":
                require(bool((g == 0).all()),
                        f"flash {name} none block: exact zeros ({layout})")
                continue
            e, scale = float((g - r).abs().max()), float(r.abs().max())
            require(e <= GRAD_TOL * scale,
                    f"flash {name} {rel} {layout}: max err {e:.3e} > "
                    f"{GRAD_TOL} x {scale:.3e}")
            errs.append(e)
        if rel == "none":
            print(f"flash_bwd none   {layout} {tuple(shape)} {dtype}: dq, "
                  f"dk, dv exactly 0", flush=True)
            continue
        print(f"flash_bwd {rel:6s} {layout} {tuple(shape)} {dtype}: "
              f"max|err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}"
              f" (of max|grad| {float(ref[0].abs().max()):.3e}, "
              f"{float(ref[1].abs().max()):.3e}, "
              f"{float(ref[2].abs().max()):.3e})", flush=True)
        err_dq, err_dkv = max(err_dq, errs[0]), max(err_dkv, *errs[1:])
    return err_dq, err_dkv


def check_smallest(fa):
    """The smallest shapes first: (1, 1, T, D) for T in 64 and 128 and every
    head dim the gate admits, the full relation, bf16, the forward and both
    backward kernels against their plain versions. A wrong shared-memory
    descriptor gives wrong numbers and no error, so every case is printed
    before the check fails."""
    bad = []
    for T in (64, 128):
        for D in range(16, 129, 16):
            shape = (1, 1, T, D)
            q, k, v = qkv(shape, D, torch.bfloat16)
            o_k, l_k = fa.flash_block(q, k, v, True, False, layout="bhtd")
            o_p, l_p = fa.flash_block_reference(q, k, v, True, False,
                                                layout="bhtd")
            args = bwd_inputs(fa, shape, "bhtd", torch.bfloat16, D, True,
                              False)
            got = fa.flash_block_bwd(*args, True, False, layout="bhtd")
            ref = fa.flash_block_bwd_reference(*args, True, False,
                                               layout="bhtd")
            torch.cuda.synchronize()
            e_out = float((o_k - o_p).abs().max())
            e_lse = float((l_k - l_p).abs().max())
            rel = [float((g - r).abs().max()) / float(r.abs().max())
                   for g, r in zip(got, ref)]
            ok = (e_out <= OUT_TOL and e_lse <= LSE_TOL
                  and max(rel) <= GRAD_TOL)
            print(f"smallest {shape} full: max|out err| {e_out:.3e} "
                  f"max|lse err| {e_lse:.3e}, max err / max|grad| dq "
                  f"{rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e}"
                  f"{'' if ok else '  FAILED'}", flush=True)
            if not ok:
                bad.append(shape)
    require(not bad, f"smallest shapes against the plain versions: {bad}")


def profile(name, fn, runs, card) -> None:
    """Each kernel's device time per run over ``runs`` calls of ``fn``, and
    the device's busy share of the wall time, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.device_time_total, reverse=True)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(f"profile {name}: {runs} runs on {card}")
    # the 20 largest, and the port's kernels wherever they rank
    for e in kernels[:20] + [e for e in kernels[20:] if "flash_" in e.key]:
        print(f"{e.device_time_total / 1e3 / runs:10.4f} ms/{name}"
              f"  x{e.count // runs:<4d} {e.key[:100]}")
    print(f"profile {name}: wall {wall_ms / runs:.3f} ms/{name}, device "
          f"{busy_ms / runs:.3f} ms/{name}, busy share "
          f"{busy_ms / wall_ms:.3f}, {len(kernels)} kernels", flush=True)


def reset_launches(fa) -> None:
    fa.KERNEL_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0


def phase_kernels(fa, card):
    """Phase 3: every kernel against its plain version, and its times."""
    B, H, T, D = BATCH, FLAGSHIP["n_heads"], FLAGSHIP["seq_len"], \
        FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    res = {}
    check_smallest(fa)
    err = check_flash(fa, (B, H, T, D), "bhtd", torch.bfloat16, 0)
    check_flash(fa, (B, H, T, D), "bhtd", torch.float32, 1)
    check_flash(fa, (4, 256, 8, 32), "bthd", torch.bfloat16, 2)
    check_flash(fa, (4, 8, 256, 32), "bhtd", torch.bfloat16, 4)

    # each kernel is timed through the wrapper that launches it
    sm = 1.0 / D ** 0.5
    q, k, v = qkv((B, H, T, D), 3, torch.bfloat16)

    def fwd():
        return fa.flash_fwd(q, k, v, False, True, sm, "bhtd")

    ms, host = time_ms(fwd), host_ms(fwd)
    plain_ms = time_ms(lambda: fa.flash_block_reference(
        q, k, v, False, True, layout="bhtd"))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    bound_ms, bound_by = flash_bound_ms(B, H, T, D, 2)
    tfs, share = rates("flash_fwd", B, H, T, D, ms, bound_ms)
    print(f"flash_fwd causal {(B, H, T, D)} bf16: kernel {ms:.4f} ms "
          f"({tfs:.1f} TF/s, bound_share {share:.3f}; its wrapper's host "
          f"time {1e3 * host:.1f} us a call), plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}) on {card}", flush=True)
    res["flash_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms, tflops=tfs,
                            bound_share=share, host_ms=host)
    del q, k, v

    e_dq, e_dkv = check_flash_bwd(fa, (B, H, T, D), "bhtd", torch.bfloat16, 0)
    check_flash_bwd(fa, (B, H, T, D), "bhtd", torch.float32, 1)
    check_flash_bwd(fa, (4, 256, 8, 32), "bthd", torch.bfloat16, 2)
    check_flash_bwd(fa, (4, 8, 256, 32), "bhtd", torch.bfloat16, 4)
    # a ragged last 128-row Q tile (flash_dq) and 128-row KV tile (flash_dkv)
    check_flash_bwd(fa, (2, 3, 192, 128), "bhtd", torch.bfloat16, 5)
    # the shapes a rank of the mesh phase gives the kernels, every relation
    # and a random lse cotangent
    for shape in mesh_kernel_shapes():
        check_flash(fa, shape, "bhtd", torch.bfloat16, 6)
        check_flash_bwd(fa, shape, "bhtd", torch.bfloat16, 6)

    # times at the causal flagship shape; dO is bf16 already, so each
    # wrapper call is its kernel and no cast
    q, k, v, dout, lse, delta = bwd_inputs(fa, (B, H, T, D), "bhtd",
                                           torch.bfloat16, 3, False, True)
    args = (q, k, v, dout, lse, delta, False, True, sm, "bhtd")

    def dq():
        return fa.flash_dq(*args)

    def dkv():
        return fa.flash_dkv(*args)

    dq_ms, dq_host = time_ms(dq), host_ms(dq)
    dkv_ms, dkv_host = time_ms(dkv), host_ms(dkv)
    plain_bwd_ms = time_ms(lambda: fa.flash_block_bwd_reference(*args))
    # the library's flash backward: one autograd.grad call through the
    # retained graph of scaled_dot_product_attention (dq, dk and dv in one)
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl,
                                                         is_causal=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        o, (ql, kl, vl), dout, retain_graph=True))
    (dq_bound, dq_by), (dkv_bound, dkv_by) = flash_bwd_bounds_ms(
        B, H, T, D, 2)
    dq_tfs, dq_share = rates("flash_dq", B, H, T, D, dq_ms, dq_bound)
    dkv_tfs, dkv_share = rates("flash_dkv", B, H, T, D, dkv_ms, dkv_bound)
    print(f"flash_dq causal {(B, H, T, D)} bf16: kernel {dq_ms:.4f} ms "
          f"({dq_tfs:.1f} TF/s, bound_share {dq_share:.3f}; host "
          f"{1e3 * dq_host:.1f} us a call), bound {dq_bound:.4f} ms "
          f"({dq_by}); flash_dkv: kernel {dkv_ms:.4f} ms "
          f"({dkv_tfs:.1f} TF/s, bound_share {dkv_share:.3f}; host "
          f"{1e3 * dkv_host:.1f} us a call), bound "
          f"{dkv_bound:.4f} ms ({dkv_by}); plain "
          f"backward (dq, dk, dv) {plain_bwd_ms:.4f} ms; library backward "
          f"(torch.autograd.grad of scaled_dot_product_attention, dq, dk "
          f"and dv) {lib_bwd_ms:.4f} ms on {card}", flush=True)
    res["flash_dq"] = dict(max_abs_err=e_dq, ms=dq_ms, plain_ms=plain_bwd_ms,
                           bound_ms=dq_bound, bound_by=dq_by,
                           library_ms=lib_bwd_ms, tflops=dq_tfs,
                           bound_share=dq_share, host_ms=dq_host)
    res["flash_dkv"] = dict(max_abs_err=e_dkv, ms=dkv_ms,
                            plain_ms=plain_bwd_ms, bound_ms=dkv_bound,
                            bound_by=dkv_by, library_ms=lib_bwd_ms,
                            tflops=dkv_tfs, bound_share=dkv_share,
                            host_ms=dkv_host)
    return res


def phase_serve(fa, tfm, entry_mod, params, cfg, card):
    """Phase 4, serving: REQUESTS flagship forwards, then entry("cuda")."""
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, size=(BATCH, cfg.seq_len))).to("cuda")
        for _ in range(REQUESTS)]

    def serve(tokens):
        return tfm.forward(params, tokens, cfg)

    serve(batches[0])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    reset_launches(fa)
    times, first = [], None
    for tokens in batches:
        t0 = time.perf_counter()
        logits = serve(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        require(tuple(logits.shape) == (BATCH, cfg.seq_len, cfg.vocab),
                f"logits shape {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), "logits finite")
        if first is None:
            first = logits
        del logits
    counts = launch_counts()
    require(counts == {"flash_fwd": REQUESTS * cfg.n_layers, "flash_dq": 0,
                       "flash_dkv": 0},
            f"serving launched {counts}, expected flash_fwd "
            f"{REQUESTS * cfg.n_layers} times and no backward kernel")
    plain = tfm.forward(params, batches[0], cfg, use_flash=False)
    logits_err = float((first - plain).abs().max())
    require(bool(torch.allclose(first, plain, atol=LOGITS_TOL,
                                rtol=LOGITS_TOL)),
            f"logits vs plain attention path: max abs err {logits_err}")
    fwd_ms = 1e3 * sum(times) / len(times)
    print(f"forward {cfg} batch {BATCH}: {fwd_ms:.3f} ms/request "
          f"({', '.join(f'{1e3 * t:.3f}' for t in times)}), "
          f"{BATCH * cfg.seq_len / (fwd_ms / 1e3):.1f} tokens/s, "
          f"flash_fwd launches {counts['flash_fwd']}, max|logits - plain| "
          f"{logits_err:.3e} on {card}", flush=True)
    del first, plain

    # the user's entry point, on the card
    fn, fn_args = entry_mod.entry("cuda")
    ecfg = entry_mod.ENTRY_CONFIG
    reset_launches(fa)
    e_logits = fn(*fn_args)
    torch.cuda.synchronize()
    e_launches = fa.KERNEL_LAUNCHES
    require(e_launches == ecfg.n_layers,
            f"entry(): flash_fwd launched {e_launches} times, expected "
            f"{ecfg.n_layers}")
    require(bool(torch.isfinite(e_logits).all()), "entry() logits finite")
    e_plain = tfm.forward(*fn_args, ecfg, use_flash=False)
    e_err = float((e_logits - e_plain).abs().max())
    require(bool(torch.allclose(e_logits, e_plain, atol=LOGITS_TOL,
                                rtol=LOGITS_TOL)),
            f"entry() logits vs plain attention path: max abs err {e_err}")
    print(f"entry() {ecfg}: logits {tuple(e_logits.shape)}, flash_fwd "
          f"launches {e_launches}, max|logits - plain| {e_err:.3e}",
          flush=True)
    return counts, batches[0]


def leaf_names(params, prefix=""):
    """Names of the parameters in ``param_leaves`` order."""
    if isinstance(params, dict):
        sep = "." if prefix else ""
        return [n for k in sorted(params)
                for n in leaf_names(params[k], f"{prefix}{sep}{k}")]
    if isinstance(params, list):
        return [n for i, x in enumerate(params)
                for n in leaf_names(x, f"{prefix}[{i}]")]
    return [prefix]


def phase_train(fa, tfm, params, cfg, card):
    """Phase 4, training: the first step's loss and gradients against the
    plain attention path, then a warm-up step and STEPS timed steps."""
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab, size=(BATCH, cfg.seq_len))
    step, place = tfm.make_train_step(cfg, "cuda")
    params, toks, tgts = place(params, toks, np.roll(toks, -1, axis=1))

    loss_k, grads_k = tfm.loss_and_grads(params, toks, tgts, cfg)
    loss_p, grads_p = tfm.loss_and_grads(params, toks, tgts, cfg,
                                         use_flash=False)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    names = leaf_names(params)
    rl2 = {n: float((a - b).norm() / b.norm().clamp_min(1e-30))
           for n, a, b in zip(names, grads_k, grads_p)}
    worst = max(rl2, key=rl2.get)
    # gradients that only the forward kernel, and no attention backward,
    # feeds: the last block's output projection and MLP, and ln_f
    last = f"blocks[{cfg.n_layers - 1}]"
    fwd_only = max(rl2[n] for n in names if n == "ln_f" or (
        n.startswith(last) and not n.endswith(("ln1", "qkv"))))
    require(bool(torch.isfinite(loss_k)) and loss_err <= LOSS_RTOL,
            f"training loss {float(loss_k)} vs plain attention path "
            f"{float(loss_p)}: relative error {loss_err:.3e}")
    require(rl2[worst] <= GRAD_RL2,
            f"gradients vs plain attention path: relative L2 error "
            f"{rl2[worst]:.3e} on {worst}")
    print(f"train step 1 vs plain attention path: loss {float(loss_k):.6f} "
          f"vs {float(loss_p):.6f} (relative error {loss_err:.3e}), "
          f"gradients' relative L2 error largest {rl2[worst]:.3e} "
          f"({worst}), median {sorted(rl2.values())[len(rl2) // 2]:.3e} "
          f"over {len(rl2)} tensors, largest on tensors no attention "
          f"backward reaches {fwd_only:.3e}", flush=True)
    del grads_k, grads_p

    step(params, toks, tgts)  # warm-up
    torch.cuda.synchronize()
    reset_launches(fa)
    times, losses = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss, params = step(params, toks, tgts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = launch_counts()
    want = STEPS * cfg.n_layers
    require(counts == {name: want for name in counts},
            f"training launched {counts}, expected {want} of each kernel")
    require(all(np.isfinite(losses)), f"training losses {losses} finite")
    step_ms = 1e3 * sum(times) / len(times)
    tokens = BATCH * cfg.seq_len
    flops = train_flops(params, cfg, tokens)
    mfu = flops / (step_ms / 1e3) / PEAK_BF16_FLOPS
    print(f"train {cfg} batch {BATCH}: {step_ms:.3f} ms/step "
          f"({', '.join(f'{1e3 * t:.3f}' for t in times)}), "
          f"{tokens / (step_ms / 1e3):.1f} tokens/s, train_mfu {mfu:.4f} "
          f"({flops / 1e12:.3f} TFLOP/step over "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TF/s), losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}, launches {counts} "
          f"on {card}", flush=True)
    return counts, (step, params, toks, tgts)


# the multi-rank phase: the flagship's width at 2 layers, global batch 4
MESH_MODEL = dict(FLAGSHIP, n_layers=2)
MESH_LAYOUT = (2, 2, 2)
MESH_BATCH = 4
RING_SHAPE = (BATCH, FLAGSHIP["n_heads"], FLAGSHIP["seq_len"],
              FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])
RING_SPS = (2, 4)


def mesh_kernel_shapes():
    """The [B, H, T, D] blocks one rank's kernels take in the mesh phase:
    the ring's sequence shard at each sp, then the step's batch, head and
    sequence shard."""
    B, H, T, D = RING_SHAPE
    dp, sp, tp = MESH_LAYOUT
    return [(B, H, T // n, D) for n in RING_SPS] + [
        (MESH_BATCH // dp, MESH_MODEL["n_heads"] // tp,
         MESH_MODEL["seq_len"] // sp, D)]


def _world_ms(fn):
    """fn() between two barriers of the world, with the card synchronised:
    (its result, wall ms)."""
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dist.barrier()
    return out, 1e3 * (time.perf_counter() - t0)


def _ring_rank(sp, seed):
    """One rank of the ring world: causal ring attention forward and
    backward on its sequence shard, once to warm up and once counted and
    timed; rank 0 holds the gathered output and gradients against one
    flash_block of the whole sequence."""
    from ompi_tpu_torch.ops import flash_attention as fa
    from ompi_tpu_torch.ops import ring_attention as ra
    from ompi_tpu_torch.parallel import axes

    mesh = axes.current_mesh()
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(RING_SHAPE).astype(
        np.float32)).to(mesh.device, torch.bfloat16) for _ in range(4))
    r, n = axes.rank("sp"), RING_SHAPE[2] // sp
    mine = lambda x: x[:, :, r * n:(r + 1) * n].contiguous()

    def run():
        local = [mine(x).requires_grad_() for x in (q, k, v)]
        o = ra.ring_attention(*local, "sp", sp, causal=True, layout="bhtd")
        o.backward(mine(g))
        return [o.detach()] + [x.grad for x in local]

    run()
    reset_launches(fa)
    got, ms = _world_ms(run)
    counts = launch_counts()
    with torch.no_grad():
        got = [axes.allgather(x, "sp", concat_dim=2) for x in got]
    out = dict(counts=counts, ms=ms, transport=mesh.backend,
               staged=mesh.staged)
    if r == 0:
        ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        o_ref, _ = fa.flash_block(*ref, False, True, layout="bhtd")
        o_ref.backward(g.float())
        ref = [o_ref.detach()] + [x.grad for x in ref]
        out["err"] = {name: float((a.float() - b.float()).abs().max()
                                  / b.float().abs().max())
                      for name, a, b in zip(("out", "dq", "dk", "dv"),
                                            got, ref)}
    return out


def _step_rank(model, batch, seed):
    """One rank of the (dp, sp, tp) training world: the first step's loss
    and gradients (reduced over ("dp", "sp"), gathered over tp), held by
    rank 0 against the single-rank path on the card; the wall ms of a
    forward and backward and of the gradient allreduce; then two counted,
    timed steps."""
    from ompi_tpu_torch.models import transformer as tfm
    from ompi_tpu_torch.ops import flash_attention as fa
    from ompi_tpu_torch.parallel import axes

    mesh = axes.current_mesh()
    dims = tuple(mesh.shape[a] for a in axes.AXES)
    cfg = tfm.Config(**model)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             mesh.device)
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, size=(batch, cfg.seq_len))
    tgts = np.roll(toks, -1, axis=1)
    step, place = tfm.make_train_step(cfg, mesh.device, *dims)
    local, t, g = place(params, toks, tgts)

    loss, grads = tfm.loss_and_grads(local, t, g, cfg)
    loss = float(axes.allreduce(loss, ("dp", "sp")))
    grads = tfm.gather_params(tfm.allreduce_grads(grads),
                              tfm.param_leaves(tfm.param_specs(cfg)))
    out = dict(transport=mesh.backend, staged=mesh.staged)
    if axes.rank(("dp", "sp")) == 0 and axes.rank("tp") == 0:
        # the replicated leaves of ``local`` are ``params``' own tensors:
        # the reference runs before any step updates them
        with axes.use_mesh(None):
            full_t, full_g = (torch.from_numpy(x).to(mesh.device)
                              for x in (toks, tgts))
            loss_1, grads_1 = tfm.loss_and_grads(params, full_t, full_g, cfg)
        names = leaf_names(params)
        out["loss"], out["loss_1"] = loss, float(loss_1)
        out["rl2"] = {n: float((a - b).norm() / b.norm().clamp_min(1e-30))
                      for n, a, b in zip(names, grads, grads_1)}
        del grads_1
    # where a step's wall time goes: forward and backward (the ring's
    # shifts and the tp allreduces in them), then the gradient allreduce,
    # in one buffer as the step does it and one a leaf, in turns
    (_, grads), out["fb_ms"] = _world_ms(
        lambda: tfm.loss_and_grads(local, t, g, cfg))
    ar = {"flat": lambda: tfm.allreduce_grads(grads),
          "leaf": lambda: [axes.allreduce(x, ("dp", "sp")) for x in grads]}
    out["ar_ms"] = {k: [] for k in ar}
    for k in ("flat", "leaf", "leaf", "flat"):
        out["ar_ms"][k].append(_world_ms(ar[k])[1])
    del grads
    reset_launches(fa)
    (loss1, _), out["ms"] = _world_ms(lambda: step(local, t, g))
    out["counts"] = launch_counts()
    (loss2, _), out["ms2"] = _world_ms(lambda: step(local, t, g))
    out["losses"] = [float(loss1), float(loss2)]
    return out


def phase_mesh(card):
    """Phase 4c: the ring worlds at sp = 2 and 4, then the training world;
    returns each kernel's launches a rank in the step."""
    from ompi_tpu_torch.parallel.launch import run_world

    for sp in RING_SPS:
        t0 = time.perf_counter()
        ranks = run_world(_ring_rank, sp, "cuda", sp, 10 + sp,
                          shape=(1, sp, 1), timeout=400)
        world_s = time.perf_counter() - t0
        err = ranks[0]["err"]
        counts = [rk["counts"] for rk in ranks]
        print(f"mesh ring sp={sp} {RING_SHAPE} bf16 causal over "
              f"{ranks[0]['transport']} (host-staged: {ranks[0]['staged']}):"
              f" max err / max|x| out {err['out']:.3e} dq {err['dq']:.3e} "
              f"dk {err['dk']:.3e} dv {err['dv']:.3e}; forward+backward wall "
              f"ms by rank {[round(rk['ms'], 3) for rk in ranks]}; launches "
              f"a rank {counts[0]}; world {world_s:.1f} s with start-up, "
              f"{sp} processes on {card}", flush=True)
        require(all(c == {name: sp for name in c} for c in counts),
                f"ring sp={sp}: launches by rank {counts}, expected {sp} "
                f"of each kernel on every rank")
        require(max(err.values()) <= GRAD_TOL,
                f"ring sp={sp} against one flash_block: {err} > {GRAD_TOL}")

    dp, sp, tp = MESH_LAYOUT
    t0 = time.perf_counter()
    ranks = run_world(_step_rank, dp * sp * tp, "cuda", MESH_MODEL,
                      MESH_BATCH, 2, shape=MESH_LAYOUT, timeout=900)
    world_s = time.perf_counter() - t0
    head = ranks[0]
    loss_err = abs(head["loss"] - head["loss_1"]) / abs(head["loss_1"])
    worst = max(head["rl2"], key=head["rl2"].get)
    want = sp * MESH_MODEL["n_layers"]
    counts = [rk["counts"] for rk in ranks]
    losses = head["losses"]
    ar_ms = {k: [round(x, 3) for x in v] for k, v in head["ar_ms"].items()}
    print(f"mesh step {MESH_LAYOUT} (dp, sp, tp), {MESH_MODEL}, global batch "
          f"{MESH_BATCH} over {head['transport']} (host-staged: "
          f"{head['staged']}): loss {head['loss']:.6f} vs single-rank "
          f"{head['loss_1']:.6f} (relative error {loss_err:.3e}), gradients' "
          f"relative L2 error largest {head['rl2'][worst]:.3e} ({worst}), "
          f"median {sorted(head['rl2'].values())[len(head['rl2']) // 2]:.3e}"
          f" over {len(head['rl2'])} tensors; steps' losses "
          f"{losses[0]:.6f}, {losses[1]:.6f}; step wall ms by rank "
          f"{[round(rk['ms'], 3) for rk in ranks]}, second step "
          f"{[round(rk['ms2'], 3) for rk in ranks]}; of a step on rank 0, "
          f"forward+backward {head['fb_ms']:.3f} ms and the gradient "
          f"allreduce over (dp, sp) {ar_ms['flat']} ms in one buffer, "
          f"{ar_ms['leaf']} ms one a leaf (in turns); launches a rank and "
          f"step {counts[0]}; world {world_s:.1f} s with start-up, "
          f"{dp * sp * tp} processes on {card}", flush=True)
    require(all(c == {name: want for name in c} for c in counts),
            f"mesh step: launches by rank {counts}, expected {want} of each "
            f"kernel on every rank")
    require(np.isfinite(head["loss"]) and loss_err <= LOSS_RTOL,
            f"mesh step loss {head['loss']} vs single-rank {head['loss_1']}")
    require(head["rl2"][worst] <= GRAD_RL2,
            f"mesh step gradients vs single-rank: {head['rl2'][worst]:.3e} "
            f"on {worst}")
    require(all(np.isfinite(losses)) and losses[1] < losses[0],
            f"mesh steps' losses {losses}: finite and falling")
    return counts[0]


# the communicator phase (4d): mesh_world(8) on the card against the CPU
COMM_W = 8
COMM_ELEMS = 257  # elements a row of the parity payloads (a ragged tail)
COMM_ROOT = 1
# the ops of the parity matrix and the payloads each takes (USER is a
# non-commutative user op)
COMM_OPS = {"SUM": "fib", "PROD": "fib", "MAX": "fib", "MIN": "fib",
            "LAND": "fib", "LOR": "fib", "BAND": "ib", "MINLOC": "fi",
            "MAXLOC": "fi", "USER": "fi"}
COMM_DTYPES = {"f": np.float32, "i": np.int32, "b": np.bool_}
COMM_OP_VERBS = ("allreduce", "reduce", "reduce_scatter", "scan", "exscan")
COMM_VERBS = COMM_OP_VERBS + (
    "bcast", "allgather", "gather", "alltoall", "scatter", "shift",
    "permute", "cart_shift", "neighbor_allgather", "neighbor_alltoall",
    "barrier")
# f32 allreduce bytes a rank (bench.py:138) and the 16 MB total of
# bench.py:469 for bcast, allgather and alltoall
COMM_SWEEP = (1 << 10, 1 << 15, 1 << 20, 1 << 24, 1 << 26)
COMM_VERB_BYTES = 1 << 24


def comm_layouts(world):
    """The communicators of the comm phase, built alike on either world:
    the world, Split(r % 2) (recursive doubling), the non-uniform
    Split([0,0,0,1,1,2,3,3]) (the masked ring), a Split with UNDEFINED
    colours (a ring of 3 and singletons), Create_group([0, 2, 5]), and a
    2x4 cart, periodic and not, with the open one's Sub."""
    from ompi_tpu_torch.parallel.mesh import UNDEFINED as U

    cart_open = world.Create_cart([2, 4], [False, False])
    return {"world": world,
            "split_r%2": world.Split([r % 2 for r in range(COMM_W)]),
            "split_nonuniform": world.Split([0, 0, 0, 1, 1, 2, 3, 3]),
            "split_undefined": world.Split([0, 1, U, 0, 1, U, 0, 1]),
            "create_group": world.Create_group([0, 2, 5]),
            "cart_periodic": world.Create_cart([2, 4], [True, True]),
            "cart_open": cart_open,
            "cart_sub": cart_open.Sub([False, True])}


def comm_payload(rng, shape, dtype, pair=False):
    """Numpy payload: normals, small ints or bools; pairs are (value with
    ties, index) in the last dim."""
    if pair:
        return np.stack([rng.randint(0, 3, shape), rng.randint(0, 8, shape)],
                        -1).astype(dtype)
    if dtype == np.bool_:
        return rng.rand(*shape) > 0.5
    if dtype == np.int32:
        return rng.randint(-4, 5, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def comm_cases(comm, verb, ops, rng):
    """(label, fn(comm, x), x, world float SUM) for each call of ``verb``
    on ``comm``: every op and payload for the op verbs, every payload for
    the others. ``ops`` maps an op name to the port's Op."""
    groups = comm.groups or [range(COMM_W)]
    sizes = {len(g) for g in groups if len(g) > 1}
    G = next(iter(sizes)) if len(sizes) == 1 else 2
    K = 2 * len(comm.topo.dims) if comm.topo is not None else 2
    blocks = verb in ("alltoall", "reduce_scatter", "scatter")
    shape = (COMM_W, G if blocks else K, COMM_ELEMS) \
        if blocks or verb == "neighbor_alltoall" else (COMM_W, COMM_ELEMS)
    calls = {
        "allreduce": lambda c, x, o: c.allreduce(x, o),
        "reduce": lambda c, x, o: c.reduce(x, o, COMM_ROOT),
        "reduce_scatter": lambda c, x, o: c.reduce_scatter(x, o),
        "scan": lambda c, x, o: c.scan(x, o),
        "exscan": lambda c, x, o: c.exscan(x, o),
        "bcast": lambda c, x: c.bcast(x, COMM_ROOT),
        "allgather": lambda c, x: c.allgather(x),
        "gather": lambda c, x: c.gather(x, COMM_ROOT),
        "alltoall": lambda c, x: c.alltoall(x),
        "scatter": lambda c, x: c.scatter(x, COMM_ROOT),
        "shift": lambda c, x: c.shift(x, 1),
        "permute": lambda c, x: c.permute(x, [(0, 1), (1, 0)]),
        "cart_shift": lambda c, x: c.cart_shift(x, 1, -1),
        "neighbor_allgather": lambda c, x: c.neighbor_allgather(x),
        "neighbor_alltoall": lambda c, x: c.neighbor_alltoall(x),
        "barrier": lambda c, x: c.barrier(),
    }[verb]
    if verb not in COMM_OP_VERBS:
        for dtype in COMM_DTYPES.values():
            yield (f"{verb} {dtype.__name__}", calls,
                   comm_payload(rng, shape, dtype), False)
        return
    for name, codes in COMM_OPS.items():
        pair = name in ("MINLOC", "MAXLOC")
        for code in codes:
            dtype = COMM_DTYPES[code]
            sums = (comm.groups is None and name == "SUM"
                    and dtype == np.float32 and verb != "scan"
                    and verb != "exscan")
            yield (f"{verb} {name} {dtype.__name__}",
                   lambda c, x, _o=name: calls(c, x, ops[c.device.type][_o]),
                   comm_payload(rng, shape, dtype, pair), sums)


def _comm_run(comm, fn, x):
    from ompi_tpu_torch.core.errors import MPIError

    try:
        return fn(comm, comm.shard(x))
    except MPIError as e:
        return ("MPIError", e.code)


def comm_parity(cpu_world, dev_world, verbs=COMM_VERBS, seed=0) -> int:
    """Every call of ``verbs`` on every communicator of ``comm_layouts``,
    on the card's world against the CPU's, on the same numpy payloads:
    bit-exact (values, sign bits, dtype), except a float SUM over the whole
    world (allreduce, reduce, reduce_scatter), whose reduction order is the
    device's own: within 1e-6 of the sum of the magnitudes it adds. A call
    the CPU comm refuses must raise the same MPI error class on the card.
    Returns (value checks, matched refusals): a call that both comms refuse
    with one error class is counted apart, as no parity of values."""
    from ompi_tpu_torch.core import op as top

    user = top.Op.Create(lambda a, b: a * b + a, commute=False)
    ops = {t: {n: user if n == "USER" else getattr(top, n) for n in COMM_OPS}
           for t in ("cpu", "cuda")}
    rng = np.random.RandomState(seed)
    cpu_comms, dev_comms = comm_layouts(cpu_world), comm_layouts(dev_world)
    checks = refusals = 0
    for lay in cpu_comms:
        for verb in verbs:
            for label, fn, x, sums in comm_cases(cpu_comms[lay], verb, ops,
                                                 rng):
                want = _comm_run(cpu_comms[lay], fn, x)
                got = _comm_run(dev_comms[lay], fn, x)
                what = f"comm parity {lay} {label}"
                if isinstance(want, tuple):
                    refusals += 1
                    require(got == want, f"{what}: card {got}, cpu {want}")
                    continue
                checks += 1
                if want is None:
                    require(got is None, f"{what}: card {got}, cpu None")
                    continue
                require(isinstance(got, torch.Tensor)
                        and got.device.type == "cuda"
                        and got.dtype == want.dtype
                        and got.shape == want.shape,
                        f"{what}: {type(got)} {getattr(got, 'shape', '')}")
                got = got.cpu()
                if sums:
                    bound = 1e-6 * np.abs(x).sum(0)
                    err = (got - want).abs().numpy()
                    require(bool((err <= bound).all()),
                            f"{what}: max err {err.max():.3e}")
                    continue
                require(torch.equal(got, want), f"{what}: values differ")
                if got.is_floating_point():
                    require(torch.equal(torch.signbit(got),
                                        torch.signbit(want)),
                            f"{what}: signs of zeros differ")
    # the masked SUM of bcast and scatter on the card: a root's -0.0
    # arrives as +0.0 (row 0 is a member in both comms), a singleton keeps
    # its own
    zeros = np.full((COMM_W, COMM_W, 3), -0.0, np.float32)
    for lay in ("world", "create_group"):
        for fn, x in ((lambda c, x: c.bcast(x, COMM_ROOT), zeros[:, 0]),
                      (lambda c, x: c.scatter(x, COMM_ROOT),
                       zeros[:, :cpu_comms[lay].size])):
            want = _comm_run(cpu_comms[lay], fn, x)
            got = _comm_run(dev_comms[lay], fn, x).cpu()
            checks += 1
            require(torch.equal(torch.signbit(got), torch.signbit(want))
                    and not bool(torch.signbit(want[0]).any()),
                    f"comm parity {lay}: signed zeros through the masked sum")
    return checks, refusals


def _comm_time(label, x, nbytes, card, **host):
    """Device ms (CUDA events) of one call of ``host["call"](x)``, the
    verb, the host us of each named way to make that call, and the memory
    bound; prints them. ``host["callable"]`` is the cached callable alone,
    the least any dispatch can cost."""
    call = host["call"]
    call(x)  # the first call resolves the callable
    ms = time_ms(lambda: call(x))
    us = {k: 1e3 * host_ms(lambda f=f: f(x)) for k, f in host.items()}
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"comm {label}: device {ms:.4f} ms, host us a call "
          + ", ".join(f"{k} {v:.1f}" for k, v in us.items())
          + f", bound {bound:.4f} ms ({nbytes} bytes read and written) on "
          f"{card}", flush=True)
    return dict(ms=ms, bound_ms=bound, **{f"host_us_{k}": v
                                          for k, v in us.items()})


def phase_comm(card):
    """Phase 4d: the mesh-mode communicator in this process, on the card
    against the CPU verb by verb, then timed at the sizes the repo's
    benchmark uses."""
    from ompi_tpu_torch.coll.mesh import cache_key
    from ompi_tpu_torch.core.op import SUM
    from ompi_tpu_torch.parallel.mesh import mesh_world

    t0 = time.perf_counter()
    cpu, dev = mesh_world(COMM_W, "cpu"), mesh_world(COMM_W)
    require(dev.device.type == "cuda", "mesh_world() lives on the card")
    checks, refusals = comm_parity(cpu, dev)
    print(f"comm parity: {checks} value checks and {refusals} calls both "
          f"comms refuse alike, of mesh_world({COMM_W}) on the card against "
          f"mesh_world({COMM_W}, 'cpu') over {len(COMM_VERBS)} verbs and "
          f"{len(comm_layouts(cpu))} communicators, all passed "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def ways(comm, verb, *args, key=None):
        """The two ways to call ``verb``: the verb, and the cached callable
        alone (no coll table, no argument checks)."""
        return dict(
            call=lambda a: getattr(comm, verb)(a, *args),
            callable=lambda a: comm._cache[key or cache_key(verb)](a))

    W, f4 = COMM_W, 4
    res = {}
    layouts = comm_layouts(dev)
    for nbytes in COMM_SWEEP:
        x = torch.ones((W, nbytes // f4), device="cuda")
        res[f"allreduce {nbytes}"] = _comm_time(
            f"allreduce SUM f32 world {nbytes} B a rank", x,
            2 * x.numel() * f4, card,
            **ways(dev, "allreduce", SUM, key=cache_key("allreduce", SUM)))
    for lay in ("split_r%2", "split_nonuniform"):  # at the sweep's 64 MB
        res[f"allreduce {lay}"] = _comm_time(
            f"allreduce SUM f32 {lay} {nbytes} B a rank", x,
            2 * x.numel() * f4, card,
            **ways(layouts[lay], "allreduce", SUM,
                   key=cache_key("allreduce", SUM)))
    del x
    per_rank = COMM_VERB_BYTES // f4 // W
    x = torch.ones((W, per_rank), device="cuda")
    bc = ways(dev, "bcast", 0)
    bc["callable"] = lambda a: dev._cache[cache_key("bcast")](a, 0)
    res["bcast"] = _comm_time(
        f"bcast f32 world {COMM_VERB_BYTES} B total", x,
        (1 + W) * per_rank * f4, card, **bc)
    res["allgather"] = _comm_time(
        f"allgather f32 world {COMM_VERB_BYTES} B total", x,
        (1 + W) * x.numel() * f4, card, **ways(dev, "allgather"))
    chunks = torch.ones((W, W, per_rank // W), device="cuda")
    res["alltoall"] = _comm_time(
        f"alltoall f32 world {COMM_VERB_BYTES} B total", chunks,
        2 * chunks.numel() * f4, card, **ways(dev, "alltoall"))
    return (checks, refusals), res


def phase_dryrun(entry_mod, card):
    """The dry run at the JAX configuration on the card against the CPU's
    loss. Its head dim of 4 is under the kernels' tile, so the dry run asks
    for the plain attention path by name: no kernel launches here."""
    cfg = entry_mod.dryrun_config(8, "cpu")
    t0 = time.perf_counter()
    card_loss = entry_mod.dryrun_multichip(8)
    cpu_loss = entry_mod.dryrun_multichip(8, "cpu")
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"dryrun_multichip(8) at the JAX configuration {cfg}: loss "
          f"{card_loss:.7f} on the card vs {cpu_loss:.7f} on the CPU "
          f"(relative {rel:.3e}); {time.perf_counter() - t0:.1f} s for both "
          f"worlds on {card}", flush=True)
    require(np.isfinite(card_loss) and rel <= 1e-5,
            f"dryrun_multichip(8) on the card {card_loss} vs CPU {cpu_loss}")


# the nonblocking phase (4f): the verbs at 64 MB a rank, f32
ASYNC_ELEMS = 16 << 20
ASYNC_STARTS = 20
# a sleep queued ahead of an i-verb: at least ASYNC_SLEEP_MIN_MS on the card
ASYNC_SLEEP_MS, ASYNC_SLEEP_MIN_MS = 50.0, 20.0
PART_SHAPE = (COMM_W, 16, 1 << 20)  # 64 MiB a rank
PART_COUNTS = (1, 4, 16)
RESHARD_N = 8192  # the global [N, N] f32 array: 32 MiB a rank sharded
RESHARD_LOWERINGS = (((0, None), (None, 0)), ((None, 0), (0, None)),
                     ((None, None), (0, None)), ((0, None), (None, None)))
ACCEL_BYTES = 256 << 20
ACCEL_COPY_BYTES = 1 << 30


def _close(got, want, sums, what):
    """The card's result against the CPU's: bit-exact (values, sign bits,
    dtype), or for a world float SUM within 1e-6 of the summed magnitudes
    ``sums``."""
    got = got.cpu()
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
            f"{tuple(want.shape)}")
    if sums is not None:
        err = (got - want).abs()
        require(bool((err <= 1e-6 * sums).all()),
                f"{what}: max err {float(err.max()):.3e}")
        return
    require(torch.equal(got, want) and torch.equal(torch.signbit(got),
                                                   torch.signbit(want)),
            f"{what}: values differ")


def _sleep_cycles(ms: float) -> int:
    """``torch.cuda._sleep`` cycles that keep the card busy about ``ms``."""
    n = 1 << 22
    ms_n = time_ms(lambda: torch.cuda._sleep(n), iters=3, warmup=1)
    return int(n * ms / ms_n)


def _shard_rows(full, spec, W):
    """The [W, *local] buffer of the global ``full`` under ``spec``: row r
    holds rank r's block of the dim that ``spec`` shards, or all of it."""
    if all(s is None for s in spec):
        return full.expand((W,) + tuple(full.shape)).contiguous()
    return torch.stack(full.chunk(W, spec.index(0)))


def async_cases(gen, W=COMM_W):
    """The i-verbs of phase 4f at 64 MB a rank, from ``gen``: (verb,
    arguments after x, CPU input, card input, the summed magnitudes of a
    world float SUM)."""
    from ompi_tpu_torch.core.op import SUM

    flat_c = torch.randn((W, ASYNC_ELEMS), generator=gen)
    blocks_c = flat_c.view(W, W, ASYNC_ELEMS // W)
    flat_d, blocks_d = flat_c.cuda(), blocks_c.cuda()
    sums = flat_c.abs().sum(0)
    return (("allreduce", (), flat_c, flat_d, sums),
            ("bcast", (COMM_ROOT,), flat_c, flat_d, None),
            ("reduce", (SUM, COMM_ROOT), flat_c, flat_d, sums),
            ("allgather", (), flat_c, flat_d, None),
            ("alltoall", (), blocks_c, blocks_d, None),
            ("reduce_scatter", (), blocks_c, blocks_d,
             blocks_c.abs().sum(0)))


def _async_iverbs(cpu, dev, cases, label="async"):
    """Each i-verb against the CPU verb and the card's blocking verb, then
    again behind queued sleep under ``set_sync_debug_mode("error")``: it
    returns before the card runs it, with no host sync."""
    cycles = _sleep_cycles(ASYNC_SLEEP_MS)
    for verb, args, x_c, x_d, s in cases:
        want = getattr(cpu, verb)(x_c, *args)
        ifn = getattr(dev, "i" + verb)
        first = ifn(x_d, *args)  # builds the callable and warms the memory
        first.Wait()
        _close(first.result, want, s, f"i{verb} 64 MB a rank vs the CPU")
        require(torch.equal(first.result, getattr(dev, verb)(x_d, *args)),
                f"i{verb} vs the blocking verb on the card")
        # asynchrony: the verb is enqueued behind a sleep and returns before
        # the card reaches it; any host sync in its callable raises here
        torch.cuda.synchronize()
        t_sleep = torch.cuda.Event(enable_timing=True)
        t_woke = torch.cuda.Event(enable_timing=True)
        t_sleep.record()
        torch.cuda._sleep(cycles)
        t_woke.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            req = ifn(x_d, *args)
            call_ms = 1e3 * (time.perf_counter() - t0)
            pending = not req.Test()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        req.Wait()
        sleep_ms = t_sleep.elapsed_time(t_woke)
        print(f"{label} i{verb}: the call {call_ms:.3f} host ms behind "
              f"{sleep_ms:.3f} ms of queued sleep, Test() "
              f"{not pending} right after it, no host sync", flush=True)
        require(sleep_ms >= ASYNC_SLEEP_MIN_MS and call_ms < sleep_ms
                and pending, f"i{verb} returns before the card runs it")
        require(torch.equal(req.result, first.result),
                f"i{verb} after the sleep")
        del first, req, want


def phase_async(card):
    """Phase 4f: the mesh comm's nonblocking, persistent and partitioned
    verbs and its reshard, on the card against the CPU comm, with device
    ms against the memory bound; then the accelerator component."""
    from ompi_tpu_torch.accelerator import get_module
    from ompi_tpu_torch.coll import persist
    from ompi_tpu_torch.core.errors import MPIError, ERR_REQUEST
    from ompi_tpu_torch.mca.var import set_var
    from ompi_tpu_torch.core.request import Request
    from ompi_tpu_torch.parallel.mesh import mesh_world

    W, f4 = COMM_W, 4
    cpu, dev = mesh_world(W, "cpu"), mesh_world(W)
    gen = torch.Generator().manual_seed(7)
    cases = async_cases(gen)
    flat_d, blocks_d = cases[0][3], cases[4][3]
    _async_iverbs(cpu, dev, cases)
    reqs = [dev.iallreduce(flat_d), dev.iallgather(flat_d),
            dev.ireduce_scatter(blocks_d)]
    Request.Waitall(reqs)
    for req, (verb, _, x_c, _, s) in zip(reqs, (cases[0], cases[3],
                                                cases[5])):
        _close(req.result, getattr(cpu, verb)(x_c), s,
               f"Waitall's i{verb}")
    del reqs

    # persistent: Start/Wait on fresh operands against the verb
    gen_d = torch.Generator("cuda").manual_seed(8)
    fresh = lambda: torch.randn((W, ASYNC_ELEMS), device="cuda",  # noqa
                                generator=gen_d)
    req = dev.allreduce_init(flat_d)
    require(req._frozen, "allreduce_init freezes the callable")
    starts, us0 = persist.starts, persist.replay_us
    for _ in range(ASYNC_STARTS):
        x = fresh()
        req.Start(x)
        req.Wait()
        require(torch.equal(req.result, dev.allreduce(x)),
                "allreduce_init's Start vs the verb")
    start_us = (persist.replay_us - us0) / (persist.starts - starts)
    verb_us = 1e3 * host_ms(lambda: dev.allreduce(x))
    start_ms = time_ms(lambda: req.Start(x).Wait())
    print(f"persistent allreduce_init 64 MB a rank: {ASYNC_STARTS} "
          f"Start/Wait bit-exact to the verb; host us a Start "
          f"{start_us:.1f}, a verb call {verb_us:.1f}; ms a Start and its "
          f"Wait {start_ms:.4f} on {card}", flush=True)
    req.Start(x)
    try:
        req.Start(x)
        refused = None
    except MPIError as e:
        refused = e.code
    req.Wait()
    require(refused == ERR_REQUEST, f"double Start raises ({refused})")
    set_var("coll_persist", "donate", 1)
    try:
        x0 = flat_d.clone()
        req = dev.allreduce_init(x0)
        x = fresh()
        want = dev.allreduce(x)
        req.Start(x)
        req.Wait()
        require(req.result.data_ptr() == x.data_ptr()
                and torch.equal(req.result, want),
                "a donated Start writes the result into its operand")
        donated_ms = time_ms(lambda: req.Start(x).Wait())
        req.Start()
        req.Wait()
        require(torch.equal(req.result, dev.allreduce(flat_d))
                and torch.equal(x0, flat_d),
                "an operand-less restart runs on the init operand")
    finally:
        set_var("coll_persist", "donate", 0)
    print(f"persistent donated Start 64 MB a rank: the result in the "
          f"operand's storage; ms a Start and its Wait {donated_ms:.4f} "
          f"(the copy into the operand included) on {card}", flush=True)
    del req, x, x0, want

    # partitioned: a ring shift of [8, 16, 2^20] in 1, 4 and 16 segments
    ring = tuple((i, (i + 1) % W) for i in range(W))
    xp_c = torch.randn(PART_SHAPE, generator=gen)
    xp_d = xp_c.cuda()
    whole = dev.permute(xp_d, ring)
    _close(whole, cpu.permute(xp_c, ring), None, "permute vs the CPU")
    nbytes = 2 * xp_d.numel() * f4
    bound = nbytes / PEAK_BYTES * 1e3
    for parts in PART_COUNTS:
        req = dev.Psend_init(xp_d, ring, parts)

        def run(req=req, parts=parts):
            req.Start()
            req.Pready_range(0, parts - 1)
            return req.Wait()

        require(torch.equal(run(), whole),
                f"{parts} partitions vs one permute")
        ms = time_ms(run)
        print(f"partitioned ring shift {list(PART_SHAPE)} f32, {parts} "
              f"partitions: device {ms:.4f} ms (Start to Wait), bound "
              f"{bound:.4f} ms ({nbytes} bytes read and written) on {card}",
              flush=True)
    del xp_c, xp_d, whole, req

    # reshard: the four lowerings of a global [8192, 8192] f32 array
    full = torch.randn((RESHARD_N, RESHARD_N), generator=gen)
    for src, dst in RESHARD_LOWERINGS:
        x_c = _shard_rows(full, src, W)
        x_d = x_c.cuda()
        got = dev.reshard(x_d, src, dst)
        want = cpu.reshard(x_c, src, dst)
        _close(got, want, None, f"reshard {src} -> {dst} vs the CPU")
        require(torch.equal(want, _shard_rows(full, dst, W)),
                f"reshard {src} -> {dst} on the CPU")
        # inputs a row needs read once, the output written once
        sharded = any(d is not None for d in src)
        nbytes = got.numel() * f4 + (x_d.numel() if sharded
                                     else got.numel()) * f4
        ms = time_ms(lambda: dev.reshard(x_d, src, dst))
        print(f"reshard {src} -> {dst} of [{RESHARD_N}, {RESHARD_N}] f32: "
              f"device {ms:.4f} ms, bound {nbytes / PEAK_BYTES * 1e3:.4f} "
              f"ms ({nbytes} bytes) on {card}", flush=True)
        del x_c, x_d, got, want
    del full

    # the accelerator component
    mod = get_module()
    require(mod.NAME == "cuda", f"the cuda component is selected "
                                f"({mod.NAME})")
    require(mod.check_addr(torch.ones(1, device="cuda"))
            and not mod.check_addr(torch.ones(1)), "check_addr")
    host = torch.randn(ACCEL_BYTES // f4, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = mod.mem_copy_to_device(host)
    mod.synchronize(on_card)
    t1 = time.perf_counter()
    back = mod.mem_copy_to_host(on_card)
    t2 = time.perf_counter()
    require(torch.equal(back, host), "a 256 MiB H2D/D2H round trip")
    bf = torch.randn((1024, 1000), device="cuda").bfloat16()
    ipc = mod.open_ipc_handle(mod.get_ipc_handle(bf))
    require(ipc.is_cuda and ipc.dtype == torch.bfloat16
            and torch.equal(ipc, bf), "an IPC round trip in bf16")
    src = mod.mem_alloc(ACCEL_COPY_BYTES)
    dst = mod.mem_alloc(ACCEL_COPY_BYTES)
    copy_ms = time_ms(lambda: dst.copy_(src))
    print(f"accelerator {mod.NAME}: H2D {ACCEL_BYTES / (t1 - t0) / 1e9:.2f}"
          f" GB/s, D2H {ACCEL_BYTES / (t2 - t1) / 1e9:.2f} GB/s (256 MiB, "
          f"pageable, host clock); get_mem_bw {mod.get_mem_bw():.0f} GB/s, "
          f"a 1 GiB device copy {copy_ms:.4f} ms = "
          f"{2 * ACCEL_COPY_BYTES / copy_ms / 1e6:.0f} GB/s read and "
          f"written on {card}", flush=True)
    mod.mem_release(src)
    mod.mem_release(dst)


# phase 4g: the quantized allreduce, the mesh window, the multi-slice comm
# and the checkpointer
QUANT_MODES = ("int8", "fp8")
QUANT_SIZES = (1 << 20, 1 << 26)  # f32 bytes a rank
QUANT_WIRE_RATIO = 3.5
WIN_ELEMS = 1 << 24  # a [8, 2^24] f32 window: a row is 64 MiB
SLICES, SLICE_D = 2, 4
SLICE_BYTES = 16 << 20  # f32 bytes a rank
SLICE_REPS = 3
CKPT_STEPS, CKPT_AT = 5, 3


def quant_gate(got, want, codec, what):
    """A quantized allreduce's row ``got`` against ``want`` (1-D, CPU): the
    non-finite elements equal, the rest within one quantization step of the
    block (``BlockCodec.quant_step``): the two sum the dequantized rows in
    other orders, which may move a block's scale by an ulp and a code by
    one step. Returns (elements that differ, the largest difference in
    steps)."""
    g, w = got.double().numpy(), want.double().numpy()
    fin = np.isfinite(w)
    require(np.array_equal(g[~fin], w[~fin], equal_nan=True),
            f"{what}: non-finite elements differ")
    step = codec.quant_step(w)[fin]
    diff = np.abs(g[fin] - w[fin])
    steps = float((diff / np.where(step > 0, step, 1.0)).max()) \
        if diff.size else 0.0
    require(bool(np.all(diff <= step * (1 + 1e-5))),
            f"{what}: {steps:.3f} quantization steps off the CPU")
    return int((diff > 0).sum()), steps


def phase_quant(card):
    """Phase 4g, quant: mesh_world(8) on the card with quant_enable set,
    int8 and fp8, at 1 MB and 64 MB a rank, against the CPU comm; device
    ms and host us beside the plain allreduce's."""
    from ompi_tpu_torch import quant
    from ompi_tpu_torch.mca.var import set_var
    from ompi_tpu_torch.parallel.mesh import mesh_world

    W, f4 = COMM_W, 4
    plain = mesh_world(W)
    require(plain.coll.providers["allreduce"] == "mesh",
            "a comm built without quant_enable keeps the plain allreduce")
    res = {}
    for mode in QUANT_MODES:
        set_var("quant", "enable", True)
        set_var("quant", "mode", mode)
        try:
            cpu, dev = mesh_world(W, "cpu"), mesh_world(W)
        finally:
            set_var("quant", "enable", False)
            set_var("quant", "mode", "int8")
        require(dev.coll.providers["allreduce"] == "quant"
                and cpu.coll.providers["allreduce"] == "quant",
                f"quant {mode}: the quantized allreduce holds the slot")
        codec = dev._quant_state.codec
        for nbytes in QUANT_SIZES:
            what = f"quant {mode} allreduce {nbytes} B a rank"
            x_c = torch.randn((W, nbytes // f4),
                              generator=torch.Generator().manual_seed(0))
            x_d = x_c.cuda()
            quant.reset_counters()
            got = dev.allreduce(x_d)
            c = quant.counters()
            require(c["colls"] == 1, f"{what}: the eligible call took the "
                                     f"quantized body ({c})")
            ratio = (c["bytes_saved"] + c["bytes_wire"]) / c["bytes_wire"]
            require(ratio >= QUANT_WIRE_RATIO,
                    f"{what}: counted wire ratio {ratio:.3f}")
            require(bool((got == got[:1]).all()), f"{what}: rows differ")
            want = cpu.allreduce(x_c)
            ndiff, steps = quant_gate(got[0].cpu(), want[0], codec, what)
            err = (got[0].cpu().double() - x_c.double().sum(0)).abs()
            bound = codec.error_bound(x_c.numpy())
            require(bool(np.all(err.numpy() <= bound)),
                    f"{what}: outside the error bound of the exact sum")
            req = dev.allreduce_init(x_d)
            req.Start()
            req.Wait()
            require(req._frozen and torch.equal(req.result, got),
                    f"{what}: allreduce_init's Start vs the verb")
            del got, want, req
            ms = {"plain": [], "quant": []}
            for k in ("plain", "quant", "quant", "plain"):
                comm = dev if k == "quant" else plain
                ms[k].append(time_ms(lambda: comm.allreduce(x_d)))
            us = {k: 1e3 * host_ms(lambda c=c: c.allreduce(x_d))
                  for k, c in (("plain", plain), ("quant", dev))}
            bound_ms = 2 * x_d.numel() * f4 / PEAK_BYTES * 1e3
            res[mode, nbytes] = dict(ms=ms, us=us, bound_ms=bound_ms)
            print(f"{what}: rows equal, {ndiff} of {x_c.shape[1]} elements "
                  f"off the CPU comm's by at most {steps:.3f} quantization "
                  f"steps, max err {float(err.max()):.4e} within the error "
                  f"bound (max {float(bound.max()):.4e}), wire ratio "
                  f"{ratio:.3f}, allreduce_init equal; device ms quantized "
                  f"{ms['quant']} vs plain {ms['plain']} (in turns), host "
                  f"us {us['quant']:.1f} vs {us['plain']:.1f}, bound "
                  f"{bound_ms:.4f} ms ({2 * x_d.numel() * f4} bytes read "
                  f"and written) on {card}", flush=True)
            del x_c, x_d, err
    return res


def phase_window(card):
    """Phase 4g, window: a [8, 2^24] f32 MeshWin on the card against one on
    the CPU under fence, PSCW and lock epochs; misuse; Rput behind queued
    work; device ms of Put and Accumulate of a 64 MB row, host us of
    Fetch_and_op."""
    from ompi_tpu_torch.core.errors import MPIError, ERR_WIN
    from ompi_tpu_torch.core.op import MAX
    from ompi_tpu_torch.osc.window import MeshWin, MODE_NOSUCCEED
    from ompi_tpu_torch.parallel.mesh import mesh_world

    W, f4 = COMM_W, 4
    wins = (MeshWin(mesh_world(W, "cpu"), (WIN_ELEMS,)),
            MeshWin(mesh_world(W), (WIN_ELEMS,)))
    gen = torch.Generator().manual_seed(9)
    rows = [torch.randn(WIN_ELEMS, generator=gen) for _ in range(3)]

    def script(win, rs):
        out = []
        win.Fence()
        win.Put(rs[0], 1)
        win.Accumulate(rs[1], 1)
        out.append(win.Get(1))
        win.Fence(MODE_NOSUCCEED)
        win.Post([2])
        win.Start([2])
        win.Put(rs[1], 2)
        win.Accumulate(rs[2], 2, MAX)
        win.Complete()
        win.Wait()
        win.Lock(5)
        win.Put(rs[2], 5)
        win.Accumulate(rs[0], 5)
        out.append(win.Get(5))
        out.append(win.Fetch_and_op(1.5, 5, 7))
        out.append(win.Compare_and_swap(out[-1] + 1.5, -1.0, 5, 7))
        win.Unlock(5)
        win.Lock_all()
        out.append(win.Get(2))
        win.Unlock_all()
        return out + [win.array]

    want = script(wins[0], rows)
    got = script(wins[1], [r.cuda() for r in rows])
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.is_cuda and torch.equal(g.cpu(), w),
                f"window: value {i} on the card vs the CPU")
    win = wins[1]
    try:
        win.Put(rows[0].cuda(), 3)
        refused = None
    except MPIError as e:
        refused = e.code
    require(refused == ERR_WIN, f"window: RMA outside an epoch ({refused})")
    row = rows[0].cuda()
    win.Lock(4)
    win.Rput(row, 4).Wait()
    cycles = _sleep_cycles(ASYNC_SLEEP_MS)
    torch.cuda.synchronize()
    t_sleep = torch.cuda.Event(enable_timing=True)
    t_woke = torch.cuda.Event(enable_timing=True)
    t_sleep.record()
    torch.cuda._sleep(cycles)
    t_woke.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        req = win.Rput(row, 4)
        call_ms = 1e3 * (time.perf_counter() - t0)
        pending = not req.Test()
        old = win.Fetch_and_op(2.0, 4, 9)  # a Python operand: no host copy
    finally:
        torch.cuda.set_sync_debug_mode(0)
    req.Wait()
    sleep_ms = t_sleep.elapsed_time(t_woke)
    require(sleep_ms >= ASYNC_SLEEP_MIN_MS and call_ms < sleep_ms and pending,
            "window: Rput returns before the card runs it")
    require(float(old) == float(row[9]) and float(win.array[4, 9])
            == float(row[9] + 2.0), "window: Fetch_and_op behind the Rput")
    win.Unlock(4)
    win.Lock_all()
    put_ms = time_ms(lambda: win.Put(row, 4))
    acc_ms = time_ms(lambda: win.Accumulate(row, 4))
    fop_us = 1e3 * host_ms(lambda: win.Fetch_and_op(1.0, 4, 3))
    win.Unlock_all()
    nb = WIN_ELEMS * f4
    put_bound, acc_bound = (k * nb / PEAK_BYTES * 1e3 for k in (2, 3))
    print(f"window [{W}, {WIN_ELEMS}] f32 on the card: fence, PSCW and lock "
          f"epochs equal to the CPU window ({len(want)} values), RMA outside "
          f"an epoch refused (ERR_WIN), Rput {call_ms:.3f} host ms behind "
          f"{sleep_ms:.3f} ms of queued sleep with Test() False, and a "
          f"Fetch_and_op behind it with no host sync; Put of a "
          f"{nb} B row {put_ms:.4f} ms (bound {put_bound:.4f}), Accumulate "
          f"{acc_ms:.4f} ms (bound {acc_bound:.4f}), Fetch_and_op "
          f"{fop_us:.1f} host us on {card}", flush=True)
    return dict(put_ms=put_ms, acc_ms=acc_ms, fop_us=fop_us,
                put_bound=put_bound, acc_bound=acc_bound)


def _slice_wall(fn):
    """Wall ms of ``fn()`` with the card synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _slice_rank(nbytes, seed):
    """One slice controller of the multi-slice world: each verb and i-verb
    on this slice's rows of one global input, against the flat verb of
    mesh_world(8, "cpu") on the whole of it; wall ms, and where the
    allreduce's time goes."""
    import torch.distributed as dist

    from ompi_tpu_torch.core import op as top
    from ompi_tpu_torch.parallel import axes
    from ompi_tpu_torch.parallel.mesh import MeshComm, mesh_world
    from ompi_tpu_torch.parallel.multislice import MultiSliceComm

    dev = axes.current_mesh().device
    s, D = dist.get_rank(), SLICE_D
    W = SLICES * D
    ms = MultiSliceComm(MeshComm(D, dev))
    flat = mesh_world(W, "cpu")
    n = nbytes // 4
    gen = torch.Generator().manual_seed(seed)
    xf = torch.randn((W, n), generator=gen)
    xi = torch.randint(0, 2, (W, n), generator=gen, dtype=torch.int32)
    xb = xf.view(W, W, n // W)
    mine = lambda t: t[s * D:(s + 1) * D]  # noqa: E731
    # name: (verb, its i-verb, global input, flat verb, summed magnitudes)
    cases = {
        "allreduce SUM f32": (ms.allreduce, ms.iallreduce, xf,
                              flat.allreduce, xf.abs().sum(0)),
        "allreduce MAX f32": (lambda a: ms.allreduce(a, top.MAX),
                              lambda a: ms.iallreduce(a, top.MAX), xf,
                              lambda a: flat.allreduce(a, top.MAX), None),
        "allreduce LOR i32 (folded)": (
            lambda a: ms.allreduce(a, top.LOR),
            lambda a: ms.iallreduce(a, top.LOR), xi,
            lambda a: flat.allreduce(a, top.LOR), None),
        "bcast": (lambda a: ms.bcast(a, 1, 2), lambda a: ms.ibcast(a, 1, 2),
                  xf, lambda a: flat.bcast(a, D + 2), None),
        "allgather": (ms.allgather, ms.iallgather, xf, flat.allgather, None),
        "reduce_scatter SUM f32": (ms.reduce_scatter, ms.ireduce_scatter,
                                   xb, flat.reduce_scatter,
                                   mine(xb.abs().sum(0))),
        "alltoall": (ms.alltoall, ms.ialltoall, xb, flat.alltoall, None),
    }
    out = dict(fails=[], ms={})
    for name, (verb, iverb, x, flat_fn, sums) in cases.items():
        x_d = mine(x).to(dev)
        got, _ = _slice_wall(lambda: verb(x_d))
        want = mine(flat_fn(x))
        g = got.cpu()
        if g.dtype != want.dtype or g.shape != want.shape:
            out["fails"].append(f"{name}: {g.dtype} {tuple(g.shape)} vs "
                                f"{want.dtype} {tuple(want.shape)}")
        elif sums is None and not torch.equal(g, want):
            out["fails"].append(f"{name}: values differ")
        elif sums is not None and not bool(
                ((g - want).abs() <= 1e-6 * sums).all()):
            out["fails"].append(f"{name}: beyond 1e-6 of the magnitudes")
        req = iverb(x_d)
        req.Wait()
        if not torch.equal(req.result, got):
            out["fails"].append(f"i{name}: differs from the blocking verb")
        del got, want, g, req
        out["ms"][name] = [_slice_wall(lambda: verb(x_d))[1]
                           for _ in range(SLICE_REPS)]
    req = ms.ibarrier()
    ms.barrier()
    if not req.Test():
        out["fails"].append("a barrier overtook the ibarrier")
    # the allreduce's hops: slice-local verb, D2H, bridge, H2D and expand
    x_d = mine(xf).to(dev)
    parts = {k: [] for k in ("slice", "d2h", "bridge", "h2d")}
    for _ in range(SLICE_REPS):
        dist.barrier(group=ms.bridge)
        local, t = _slice_wall(lambda: ms.slice.allreduce(x_d))
        parts["slice"].append(t)
        row, t = _slice_wall(lambda: local[0].cpu())
        parts["d2h"].append(t)
        dist.barrier(group=ms.bridge)  # the exchange alone, not the skew
        comb, t = _slice_wall(lambda: ms._host_exchange(row, top.SUM))
        parts["bridge"].append(t)
        parts["h2d"].append(_slice_wall(lambda: ms._replicate(comb))[1])
    out["parts"] = parts
    ms.Free()
    out["transport"] = axes.current_mesh().backend
    return out


def phase_multislice(card):
    """Phase 4g, multi-slice: 2 slice controllers sharing the card, each a
    MeshComm(4), every verb and i-verb against the flat CPU verb."""
    from ompi_tpu_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    ranks = run_world(_slice_rank, SLICES, "cuda", SLICE_BYTES, 21,
                      timeout=600)
    world_s = time.perf_counter() - t0
    for r, rk in enumerate(ranks):
        require(not rk["fails"], f"multi-slice slice {r}: {rk['fails']}")
    head = ranks[0]
    parts = {k: float(np.median(v)) for k, v in head["parts"].items()}
    share = parts["bridge"] / sum(parts.values())
    walls = {k: [round(x, 3) for x in v] for k, v in head["ms"].items()}
    print(f"multi-slice {SLICES} slices x MeshComm({SLICE_D}) sharing the "
          f"card, bridge over gloo (world {head['transport']}), "
          f"{SLICE_BYTES} B a rank: every verb and i-verb equal to "
          f"mesh_world({SLICES * SLICE_D}, 'cpu')'s flat verb (float SUM "
          f"within 1e-6); wall ms on slice 0 {walls}; the allreduce's hops "
          f"(median ms) slice {parts['slice']:.3f}, D2H {parts['d2h']:.3f}, "
          f"bridge {parts['bridge']:.3f}, H2D and expand "
          f"{parts['h2d']:.3f}: the staged bridge hop {share:.3f} of it; "
          f"world {world_s:.1f} s with start-up on {card}", flush=True)
    return dict(ms=head["ms"], parts=parts, bridge_share=share)


def phase_checkpoint(fa, tfm, card):
    """Phase 4g, checkpoint, at the flagship width: 5 steps straight, twice
    (the card's spread); then 3 steps, save, restore into fresh tensors on
    the card, 2 steps, with the kernel launch counts reset before it and
    read after. Returns the counts."""
    import os
    import tempfile

    from ompi_tpu_torch.runtime.checkpoint import MeshCheckpointer

    cfg = tfm.Config(**FLAGSHIP)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab, size=(BATCH, cfg.seq_len))
    step, place = tfm.make_train_step(cfg, "cuda")

    def fresh():
        return place(tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cuda"), toks, np.roll(toks, -1, axis=1))

    def run(p, t, g, n):
        return [float(step(p, t, g)[0]) for _ in range(n)]

    runs = []
    for _ in range(2):
        p, t, g = fresh()
        runs.append(run(p, t, g, CKPT_STEPS))
        del p
    spread = max(abs(a - b) for a, b in zip(*runs))
    reset_launches(fa)
    p, t, g = fresh()
    first = run(p, t, g, CKPT_AT)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        ck = MeshCheckpointer(d)
        _, save_ms = _slice_wall(lambda: ck.save(CKPT_AT, p))
        nbytes = os.path.getsize(os.path.join(d, str(CKPT_AT), "state.pt"))
        restored, restore_ms = _slice_wall(
            lambda: ck.restore(CKPT_AT, specs=tfm.param_specs(cfg)))
        ck.close()
    saved, back = tfm.param_leaves(p), tfm.param_leaves(restored)
    require(all(b.is_cuda and b.data_ptr() != a.data_ptr()
                and torch.equal(a, b) for a, b in zip(saved, back)),
            "checkpoint: restored into fresh tensors on the card, equal to "
            "the saved ones")
    del p, saved
    resumed = run(restored, t, g, CKPT_STEPS - CKPT_AT)
    counts = launch_counts()
    want = CKPT_STEPS * cfg.n_layers
    off = max(abs(a - b) for a, b in zip(first + resumed, runs[0]))
    print(f"checkpoint {cfg} batch {BATCH}: losses straight "
          f"{runs[0]}, again {runs[1]} (spread {spread:.3e}); {CKPT_AT} "
          f"steps, save, restore, {CKPT_STEPS - CKPT_AT} steps: {first} + "
          f"{resumed} (largest difference to the straight run {off:.3e}); "
          f"checkpoint {nbytes} B, save {save_ms:.1f} ms, restore "
          f"{restore_ms:.1f} ms (wall); launches {counts} on {card}",
          flush=True)
    require(all(np.isfinite(runs[0])) and off <= spread,
            f"checkpoint: the resumed losses are {off:.3e} off the straight "
            f"run's, beyond the card's spread {spread:.3e}")
    require(counts == {name: want for name in counts},
            f"checkpoint: launched {counts}, expected {want} of each kernel")
    return counts


def _example_lines(example, argv):
    """The stdout lines of ``example.main(argv)``."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = example.main(argv)
    require(rc == 0, f"mesh_allreduce {argv} exits 0")
    return buf.getvalue().splitlines()


def phase_bench(fa, card):
    """Phase 4h: the port's bench legs at bench.py's sizes, the three
    profiling tools once each, the mesh_allreduce example. Returns each
    kernel's launches in bench_mfu's timed full steps."""
    from ompi_tpu_torch.examples import mesh_allreduce as example
    from ompi_tpu_torch.parallel.mesh import mesh_world
    from ompi_tpu_torch.tools import attn_probe, bench, profile_flash
    from ompi_tpu_torch.tools import profile_mfu

    t0 = time.perf_counter()
    world = mesh_world(COMM_W)
    # the legs hold each verb's result against its raw counterpart's and
    # raise where they differ
    for row in bench.bench_allreduce_sweep(world, COMM_W):
        print(f"bench allreduce {row['bytes']} B a rank: verb "
              f"{row['ours_gbps']:.3f} GB/s, raw {row['raw_gbps']:.3f} GB/s "
              f"(bus), fraction {row['fraction']:.4f}, results equal on "
              f"{card}", flush=True)
    for name, row in bench.bench_verbs(world, COMM_W).items():
        print(f"bench {name}: verb {1e3 * row['ours_s']:.4f} ms, raw "
              f"{1e3 * row['raw_s']:.4f} ms, fraction {row['fraction']:.4f}, "
              f"results equal on {card}", flush=True)
    tax = bench.bench_dispatch_tax(world)
    print(f"bench dispatch tax: allreduce {tax['ours_us']:.1f} us, raw "
          f"{tax['raw_us']:.1f} us, overhead {tax['overhead_us']:.1f} us, "
          f"prologue {tax['prologue_us']:.3f} us; per verb (us, layer "
          f"overhead us) " + ", ".join(
              f"{k} {v['us']:.1f} {v['layer_overhead_us']:.1f}"
              for k, v in tax["verb_sweep"].items())
          + f" on {card}", flush=True)
    require(all("us" in v for v in tax["verb_sweep"].values()),
            f"dispatch tax: every verb's callable cached {tax['verb_sweep']}")
    for row in bench.bench_quant_sweep(world, COMM_W):
        require("skipped" not in row, f"quant sweep: {row}")
        print(f"bench quant allreduce {row['bytes']} B a rank: fp32 "
              f"{1e3 * row['fp32_s']:.4f} ms, quantized "
              f"{1e3 * row['quant_s']:.4f} ms, fraction "
              f"{row['fraction']:.4f}, max err / bound "
              f"{row['max_err_vs_bound']:.4f} on {card}", flush=True)
        require(row["max_err_vs_bound"] <= 1.0,
                f"quant sweep {row['bytes']} B: outside the codec's bound")
    legs_s = time.perf_counter() - t0

    reset_launches(fa)
    mfu = bench.bench_mfu()
    counts = launch_counts()
    L, k = mfu["config"]["n_layers"], mfu["ksteps"]
    abl = mfu["ablations"]
    print(f"bench model step {mfu['config']} batch {mfu['batch']}: "
          f"{1e3 * mfu['step_s']:.3f} ms/step over {k} steps, "
          f"{mfu['tokens_per_s']:.1f} tokens/s, {mfu['tflops_per_s']:.2f} "
          f"TF/s, train_mfu {mfu.get('mfu', 'n/a')}, first loss "
          f"{mfu['first_loss']:.6f}, peak allocated "
          f"{mfu['peak_bytes']} B; ablations full {abl['full_ms']:.3f}, "
          f"ce_loss {abl['ce_loss_ms']:.3f}, attention "
          f"{abl['attention_ms']:.3f}, other {abl['other_ms']:.3f} ms; "
          f"launches in the timed full steps {mfu['launches']}, identity "
          f"attention {abl['identity_attention_launches']}, all of bench_mfu "
          f"{counts} on {card}", flush=True)
    require(np.isfinite(mfu["first_loss"]) and "mfu" in mfu,
            "bench model step: a finite loss and an mfu")
    require(mfu["launches"] == {n: k * L for n in counts},
            f"bench model step launched {mfu['launches']}, expected {k * L} "
            f"of each kernel")
    idle = abl["identity_attention_launches"]
    require(all(v == 0 for v in idle.values()),
            f"identity attention launched {idle}")
    # the full step and the sum-loss ablation, a warm-up and k steps each
    require(counts == {n: 2 * (k + 1) * L for n in counts},
            f"bench_mfu launched {counts}, expected {2 * (k + 1) * L} of each "
            f"kernel and none under identity attention")
    mfu_s = time.perf_counter() - t0 - legs_s

    rows = profile_flash.main()
    for label in ("ours flash fwd", "ours flash fwd+bwd"):
        got = rows[label]["launches"]
        require(got["flash_fwd"] > 0 and (label.endswith("fwd")
                                          or min(got.values()) > 0),
                f"profile_flash {label}: launches {got}")
    profile_mfu.main()
    attn_probe.main()
    tools_s = time.perf_counter() - t0 - legs_s - mfu_s

    cpu = _example_lines(example, ["--device", "cpu", "--quant"])
    for argv in ([], ["--quant"]):
        lines = _example_lines(example, argv)
        for line in lines:
            print(f"example mesh_allreduce {argv}: {line}", flush=True)
        quant = "--quant" in argv
        want = [x for x in cpu if quant or "quantized" not in x]
        require(len(lines) == len(want) and "cuda" in lines[0]
                and all(a == b for a, b in zip(lines[1:], want[1:])
                        if "quantized" not in a),
                f"mesh_allreduce {argv} on the card vs the CPU: {lines}")
        if quant:
            quant_line = next(x for x in lines if "quantized" in x)
            worst = float(quant_line.split("err/bound ")[1].split()[0])
            require("provider=quant " in quant_line and worst < 1.0,
                    f"mesh_allreduce --quant: {quant_line}")
    print(f"phase 4h: {time.perf_counter() - t0:.1f} s (bench legs "
          f"{legs_s:.1f}, bench_mfu {mfu_s:.1f}, tools {tools_s:.1f}) on "
          f"{card}", flush=True)
    return mfu["launches"]


# phase 4i: the MCA variable and MPI_T layer on the card
OBS_CHILDREN = {
    # a child process each, with these variables in its environment
    "quant": {"OMPI_TPU_MCA_quant_enable": "1",
              "OMPI_TPU_MCA_coll_persist_enable": "0",
              "OMPI_TPU_MCA_accelerator_cuda_mem_bw": "1234"},
    "quant_excluded": {"OMPI_TPU_MCA_quant_enable": "1",
                       "OMPI_TPU_MCA_coll_persist_enable": "0",
                       "OMPI_TPU_MCA_accelerator_cuda_mem_bw": "1234",
                       "OMPI_TPU_MCA_coll_coll": "^quant"},
    "accelerator_excluded": {"OMPI_TPU_MCA_accelerator_accelerator": "^cuda"},
    "accelerator_nosuch": {"OMPI_TPU_MCA_accelerator_accelerator": "nosuch"},
}
OBS_STARTS = 2


def obs_inputs(device, scale=1):
    """phase 4i's inputs on ``device``: the allreduce at bench.py's sizes
    a rank (``COMM_SWEEP``), bcast and allgather at 16 MB in total, the
    alltoall's [8, 8, n] blocks; ``scale`` divides every size."""
    W = COMM_W
    gen = torch.Generator().manual_seed(11)
    xs = [torch.randn((W, max(b // 4 // scale, 1)), generator=gen).to(device)
          for b in COMM_SWEEP]
    per = max(COMM_VERB_BYTES // 4 // W // scale, W)
    x16 = torch.randn((W, per), generator=gen).to(device)
    chunks = torch.randn((W, W, per // W), generator=gen).to(device)
    return xs, x16, chunks


def obs_sequence(world, xs, x16, chunks):
    """The 4i sequence; returns its outputs and its calls of each verb (a
    persistent init runs the verb once, each Start once, an i-verb once)."""
    outs = [world.allreduce(x) for x in xs]
    outs += [world.bcast(x16, 0), world.allgather(x16),
             world.alltoall(chunks)]
    req = world.allreduce_init(xs[2])
    for _ in range(OBS_STARTS):
        req.Start()
        req.Wait()
        outs.append(req.result)
    ireq = world.iallreduce(xs[3])
    ireq.Wait()
    outs.append(ireq.result)
    calls = {"allreduce": len(xs) + 1 + OBS_STARTS + 1, "bcast": 1,
             "allgather": 1, "alltoall": 1}
    return outs, calls


def span_tree(events):
    """The B/E events of one thread of a Chrome-trace export as a tree of
    span names, [(name, [children])]; raises where they do not pair."""
    tids = {e["tid"] for e in events if e.get("ph") in ("B", "E")}
    require(len(tids) == 1, f"one thread's spans ({len(tids)} threads)")
    root, stack = [], []
    for e in events:
        if e.get("ph") == "B":
            node = (e["name"], [])
            (stack[-1][1] if stack else root).append(node)
            stack.append(node)
        elif e.get("ph") == "E":
            require(bool(stack) and stack[-1][0] == e["name"],
                    f"the export's E of {e['name']} closes its B")
            stack.pop()
    require(not stack, "every span of the export closed")
    return root


def _traced_export(run, path):
    """``run()`` with tracing on, its spans exported to ``path`` and parsed
    back; the rings are cleared before and after."""
    from ompi_tpu_torch.mca.var import set_var
    from ompi_tpu_torch.runtime import trace

    trace.reset()
    set_var("trace", "enable", True)
    try:
        out = run()
    finally:
        set_var("trace", "enable", False)
    trace.export(path)
    trace.reset()
    with open(path) as f:
        return out, json.load(f)


def obs_child(name: str) -> int:
    """One 4i child: what its environment's variables select, as a JSON
    line."""
    from ompi_tpu_torch.accelerator import get_module, is_device_buffer
    from ompi_tpu_torch.parallel.mesh import mesh_world
    from ompi_tpu_torch.runtime import spc

    out = {"child": name}
    world = mesh_world(COMM_W)
    x = torch.randn((COMM_W, 1 << 18), device="cuda")  # 1 MB a rank
    if name.startswith("quant"):
        out["provider"] = world.coll.providers["allreduce"]
        spc.reset()
        req = world.allreduce_init(x)
        req.Start()
        req.Wait()
        out["spc"] = spc.snapshot()
        out["frozen"] = req._frozen
        out["start_is_the_verb"] = torch.equal(req.result, world.allreduce(x))
        out["accelerator"] = get_module().NAME
        out["mem_bw"] = get_module().get_mem_bw()
    else:
        try:
            out["accelerator"] = get_module().NAME
            out["is_device_buffer"] = is_device_buffer(x)
        except RuntimeError as e:
            out["raised"] = str(e)
        out["stays_on_the_card"] = bool(x.is_cuda
                                        and world.allreduce(x).is_cuda)
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return 0


def _obs_children(children, card):
    """Wait for 4i's children and hold each to what its variables say."""
    res = {}
    for name, p in children.items():
        stdout, stderr = p.communicate(timeout=300)
        if p.returncode != 0:
            print(stderr[-3000:], file=sys.stderr, flush=True)
        require(p.returncode == 0, f"4i child {name} exits 0")
        res[name] = json.loads(stdout.strip().splitlines()[-1])
    q, qx = res["quant"], res["quant_excluded"]
    require(q["provider"] == "quant" and not q["frozen"]
            and q["start_is_the_verb"] and q["accelerator"] == "cuda"
            and q["mem_bw"] == 1234.0
            and q["spc"] == {"allreduce": 2, "quant_allreduce": 2},
            f"quant_enable=1, coll_persist_enable=0, cuda_mem_bw=1234: {q}")
    require(qx["provider"] == "mesh" and not qx["frozen"]
            and qx["start_is_the_verb"] and qx["spc"] == {"allreduce": 2},
            f"and coll=^quant: {qx}")
    ax, an = res["accelerator_excluded"], res["accelerator_nosuch"]
    require(ax.get("accelerator") == "null" and ax["stays_on_the_card"]
            and not ax["is_device_buffer"], f"accelerator=^cuda: {ax}")
    require("no usable component" in an.get("raised", "")
            and an["stays_on_the_card"], f"accelerator=nosuch: {an}")
    print(f"observe children: {res} on {card}", flush=True)


def phase_observe(card):
    """Phase 4i: the MCA variables, spc counters, trace spans and MPI_T
    pvars of the mesh path on the card, against the same sequence untraced
    and on a CPU comm; the variables set in child processes' environments;
    the i-verbs of 4f traced under sync debug mode; the dispatch tax with
    tracing off and on."""
    import os
    import tempfile

    from ompi_tpu_torch import mpit
    from ompi_tpu_torch.coll import mesh as coll_mesh
    from ompi_tpu_torch.mca.var import set_var
    from ompi_tpu_torch.parallel.mesh import mesh_world
    from ompi_tpu_torch.runtime import spc, trace
    from ompi_tpu_torch.tools import bench

    t0 = time.perf_counter()
    children = {
        name: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", name],
            env=dict(os.environ, **env), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for name, env in OBS_CHILDREN.items()}
    try:
        W = COMM_W
        dev, cpu = mesh_world(W), mesh_world(W, "cpu")
        inputs = obs_inputs("cuda")
        spc.reset()
        off, calls = obs_sequence(dev, *inputs)
        require(spc.snapshot() == calls,
                f"spc counts {spc.snapshot()} equal the calls {calls}")
        # every call looks up its cached callable once, a Start reuses its
        # frozen one: one cache hit a call, no miss once warm
        hits = sum(calls.values())
        mpit.init_thread()
        try:
            sess = mpit.PvarSession()
            handles = {k: sess.handle_alloc(mpit.pvar_get_index(
                "coll_mesh_" + k)) for k in ("cache_hits", "cache_misses")}
            for h in handles.values():
                h.reset()
            spc.reset()
            tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
            (on, _), doc = _traced_export(
                lambda: obs_sequence(dev, *inputs),
                os.path.join(tmp, "card.json"))
            require(spc.snapshot() == calls,
                    f"traced: spc counts {spc.snapshot()} equal the calls")
            got = {k: h.read() for k, h in handles.items()}
            require(got == {"cache_hits": hits, "cache_misses": 0},
                    f"the MPI_T session's cache pvars {got}, {hits} calls")
            absolute = {k: sess.handle_alloc(mpit.pvar_get_index(
                "coll_mesh_" + k)).read() for k in (
                    "cache_hits", "cache_misses", "compile_time_us")}
            st = coll_mesh.stats
            require(absolute == {"cache_hits": st.hits,
                                 "cache_misses": st.misses,
                                 "compile_time_us": st.compile_ns // 1000},
                    f"the coll_mesh pvars {absolute} read coll/mesh.py's "
                    f"stats")
            sess.free()
        finally:
            mpit.finalize()
        require(len(off) == len(on)
                and all(torch.equal(a, b) for a, b in zip(off, on)),
                "traced and untraced results are bit-equal")
        del off, on
        # the same sequence on a CPU comm, small: span names and nesting
        small = obs_inputs("cpu", scale=1024)
        obs_sequence(cpu, *small)
        _, cpu_doc = _traced_export(lambda: obs_sequence(cpu, *small),
                                    os.path.join(tmp, "cpu.json"))
        tree = span_tree(doc["traceEvents"])
        cpu_tree = span_tree(cpu_doc["traceEvents"])
        require(tree == cpu_tree and len(tree) == hits,
                f"the card's span tree equals the CPU comm's: {tree} vs "
                f"{cpu_tree}")
        names = sorted({e["name"] for e in doc["traceEvents"]
                        if e.get("ph") in ("B", "i")})
        print(f"observe: the 4i sequence (allreduce at {len(COMM_SWEEP)} "
              f"sizes, bcast, allgather, alltoall at 16 MB, {OBS_STARTS} "
              f"Starts, an iallreduce) traced and untraced bit-equal; spc "
              f"{calls} both times; {hits} cache hits read through MPI_T; "
              f"{len(tree)} verb spans, the tree equal to the CPU comm's; "
              f"names {names} on {card}", flush=True)
    finally:
        _obs_children(children, card)

    # the i-verbs of 4f, traced, under sync debug mode
    set_var("trace", "enable", True)
    try:
        _async_iverbs(cpu, dev, async_cases(torch.Generator().manual_seed(7)),
                      label="traced")
    finally:
        set_var("trace", "enable", False)
        trace.reset()

    # the dispatch tax, tracing off then on
    taxes = {}
    for traced in (False, True):
        set_var("trace", "enable", traced)
        try:
            taxes[traced] = bench.bench_dispatch_tax(dev)
        finally:
            set_var("trace", "enable", False)
            trace.reset()
    off_t, on_t = taxes[False], taxes[True]
    print(f"observe dispatch tax: prologue {off_t['prologue_us']:.3f} us "
          f"tracing off, {on_t['prologue_us']:.3f} on (+"
          f"{on_t['prologue_us'] - off_t['prologue_us']:.3f} us a traced "
          f"verb); allreduce floor {off_t['ours_us']:.1f} off, "
          f"{on_t['ours_us']:.1f} on; raw {off_t['raw_us']:.1f}, "
          f"{on_t['raw_us']:.1f} us on {card}", flush=True)
    print(f"phase 4i: {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the flagship forward's and training "
                         "step's kernels")
    ap.add_argument("--child", choices=sorted(OBS_CHILDREN),
                    help=argparse.SUPPRESS)  # phase 4i's child processes
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        return obs_child(args.child)
    from ompi_tpu_torch import entry as entry_mod
    from ompi_tpu_torch.models import transformer as tfm
    from ompi_tpu_torch.ops import _build
    from ompi_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, "nvidia-smi reads the card")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}", flush=True)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} "
          f"kernel(s)", flush=True)

    # 3. kernels against plain versions
    res = phase_kernels(fa, card)

    # 4. the main paths
    cfg = tfm.Config(**FLAGSHIP)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    serve_counts, tokens = phase_serve(fa, tfm, entry_mod, params, cfg, card)
    train_counts, train_args = phase_train(fa, tfm, params, cfg, card)
    mesh_counts = phase_mesh(card)
    phase_comm(card)
    phase_dryrun(entry_mod, card)
    phase_async(card)
    phase_quant(card)
    phase_window(card)
    phase_multislice(card)
    ckpt_counts = phase_checkpoint(fa, tfm, card)
    bench_counts = phase_bench(fa, card)
    phase_observe(card)

    # 5. where the time goes
    if args.profile:
        profile("request", lambda: tfm.forward(params, tokens, cfg),
                REQUESTS, card)
        step, p, toks, tgts = train_args
        profile("step", lambda: step(p, toks, tgts), 1, card)

    # 6. results
    sources = {"flash_fwd": ("flash_fwd.cu", 101),
               "flash_dq": ("flash_bwd.cu", 192),
               "flash_dkv": ("flash_bwd.cu", 231)}
    kernels = []
    for name, (src, line) in sources.items():
        n = serve_counts[name] if name == "flash_fwd" else train_counts[name]
        kernels.append({
            "name": name, "route": "cuda", "design": DESIGN[name],
            "source": f"ompi_tpu_torch/csrc/{src}",
            "replaces": f"ompi_tpu/ops/flash_attention.py:{line}",
            "launches": n, "mesh_launches_a_rank": mesh_counts[name],
            "checkpoint_launches": ckpt_counts[name],
            "bench_launches": bench_counts[name],
            **res[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
