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
4j. typed buffers (``phase_typed``): the native runs engine built with
   ``g++`` from ``ompi_tpu_torch/native/convertor.cpp`` (its path and
   build seconds printed); eight cases of 64 MB packed payload made on the
   card from a seed: every other f32 column of a [4096, 8192] matrix; the
   [4096, 4096] block of an [8192, 8192] f32 matrix (a row's subarray,
   4096 rows); FLOAT_INT pairs; DOUBLE_INT resized to the 16 bytes of a C
   struct; an int32 indexed type of 64 seeded blocks; FLOAT64 resized to
   24 bytes; bf16 and fp16 vectors of every other element. Each is staged
   to the host through the accelerator component (bf16 through an int16
   view), packed by the native engine and by the numpy path (bit-equal),
   the packed bytes copied back equal to a torch selection of the same
   elements on the card, unpacked (native and numpy, equal) into a zeroed
   buffer whose copy on the card equals the masked copy made there, and
   drained by a ``Convertor`` in 64 KB and 1 MB fragments with
   ``set_position`` out of order (equal to the whole pack); external32 of
   f32, f64 and complex64 at 64 MB against numpy's big-endian ``astype``;
   then the progress engine (a parked ``progress_until`` woken by a
   socketpair write and by ``poke``, a ``ProgressThread`` that parks and
   stops, ``Grequest`` and ``Prequest``); one JSON line with each case's
   native and numpy pack and unpack GB/s, fragment GB/s, D2H and H2D GB/s
   and the on-card gather's ms;
5. with ``--profile``: the flagship forward and one training step under
   ``torch.profiler``, the device time of the 20 largest kernels and of
   every flash kernel, and the device's busy share;
4k. the diagnostic and fault planes (``phase_diagnostics``): the host
   topology (``discover`` against the affinity mask and sysfs's NUMA
   nodes, the card in ``accelerators()`` as nvidia-smi names it, the
   cpusets of ``mesh_world(8)``'s ranks, ``bind_rank`` read back in a
   child, ``--child bind_rank``); with ``metrics_enable``, phase 4i's
   sequence on ``mesh_world(8)``: the snapshot's counters equal to spc's,
   its mesh cache pvars to ``coll/mesh.py``'s stats, the five bench gauges
   of ``bench_quant_sweep`` and ``bench_dispatch_tax`` (the bench's sizes)
   equal to their rows, the Prometheus render parsed back sample by sample
   to the snapshot, ``export_json`` round-tripped, and the host us of a
   guarded ``observe`` and ``gauge_set`` (on and off), the ms of
   ``snapshot``, ``render_prometheus`` and ``export_json``; with
   ``forensics_enable``, 8 i-verbs at 64 MB a rank whose Waits tick the
   completion counter by 8 and a ``dump()`` holding every provider; the
   sanitizer at level 2 naming exactly the i-verb left pending behind 50 ms
   of queued sleep, with its backtrace, and none after its Wait; every
   result bit-equal to the planes-off run; the i-verb's host us behind the
   queued sleep with both planes off, forensics on and the sanitizer at
   level 2; one ``{"diagnostics": ...}`` JSON line. ``qos``, ``ft/inject``,
   ``linkmodel``, the detector and ``revoke`` ride the tcp btl's wire
   (4l arms ``ft/inject`` there);
4l. the byte transfer layer (``phase_btl``): the native library (the sm
   ring and the runs engine) built with ``g++`` at first use (its path and
   build seconds printed); f32 and bf16 payloads of 64 MB, int8 of 16 MB
   and 64 MB of f32 zeros made on the card from a seed and staged to the
   host through the accelerator component (bf16 through its int16 view);
   each sent through ``SelfBtl``, a ``TcpBtl`` pair (reliable,
   ``btl_tcp_reliable=0``, ``btl_tcp_compress=1``) and an ``SmBtl`` pair
   (native ring, ``btl_sm_use_native=0``), as one frame (on sm the
   overflow file) and in ob1's fragments (1 MB on tcp, 64 KB on sm, at
   most 16 MB ahead of what arrived), twice; what arrives is uploaded to
   the card and held against the original there with ``torch.equal`` on
   its bytes; then the reliable pair under ``ft_inject_plan``
   ``corrupt(0,1,nth=7)``: the 64 MB f32 stream heals bit-exact, with CRC
   rejects and retransmits counted and no peer marked failed; one
   ``{"btl": ...}`` JSON line with GB/s per path, framing, payload and
   call, the tcp pvars per wire byte, the compressed wire ratio, D2H and
   H2D GB/s and the phase's seconds with the card;
4m. the port's process mode (``phase_procmode``): ``python -m
   ompi_tpu_torch.tools.mpirun`` re-enters this script as the rank program
   (``--child procmode_rank``) for 4 ranks over ``btl_btl=self,sm``, 4
   over ``self,tcp`` (the plain stream, ``btl_tcp_reliable=0``) and 3 over
   the default btls, all sharing the card. Each rank makes integer-valued
   f32 and bf16 payloads of 64 MB and int8 of 16 MB on the card from a
   seeded generator (and every peer's, for the closed forms); every send
   stages from the card, every receive lands in a ``DeviceBuffer``, and
   each result is held against its closed form on the card bit for bit:
   the ring of ``examples/ring.py``, Send/Recv between every pair, Bcast
   from the last rank, Allreduce SUM and MAX, Reduce, Allgather, Gather,
   Scatter, Alltoall, Reduce_scatter_block, Scan, Exscan, Split and Dup;
   the counterpart of ``tests/procmode/check_accelerator.py``; a bf16
   tensor through ``stage_to_host`` and back; a raw CUDA tensor refused as
   a receive buffer. Rank 0 times an 8-byte ping-pong, ping-pongs of 64
   KB, 1 MB and 64 MB staged from the card, a 64 MB Allreduce and D2H and
   H2D; one ``{"procmode": ...}`` line with the card. A failing rank
   fails the phase;
4n. the default host collective stack (``phase_collstack``): the port's
   ``mpirun`` re-enters this script (``--child coll_rank MODE``) for 4
   ranks over ``self,sm`` with the failure detector armed, 4 over
   ``self,tcp`` (the plain stream) and a 3-rank sessions-only job (no
   Init: ``Session.Init``, ``Comm_create_from_group``, ``Session.Finalize``),
   the sm and sessions jobs under ``coll_coll=^sm`` (their ranks share an
   sm node, where coll/sm would take the slots tuned is timed on), the tcp
   job at the default selection (sm, han and hier decline there). Each
   rank makes
   integer-valued f32 and bf16 payloads of 64 MB and a 4 KB f32 on the
   card from a seeded generator (and every peer's); every send stages
   from the card, every receive lands in a ``DeviceBuffer``, each result
   is held against its closed form on the card bit for bit: tuned's
   Allreduce at 4 KB (recursive doubling) and 64 MB (the ring), Bcast,
   Allgather, Alltoall and Reduce_scatter_block at 64 MB, with the
   component and algorithm each call took printed; every i-verb at 64 MB
   issued before 50 ms of queued card work and waited after it;
   ``Allreduce_init`` started three times with ``coll_persist_enable`` 1
   (one frozen plan) and 0, equal bits; ``Neighbor_allgather`` and
   ``Neighbor_alltoall`` on a ring dist-graph; the host ms of a 64 MB
   Allreduce through tuned and through coll/basic on the same job; in the
   sm job, ``ft.inject`` kills the last rank, and the survivors revoke,
   ``Shrink`` and Allreduce from the card. The 64 MB Allreduce's host ms
   and the phase's seconds are printed with the card; one
   ``{"collstack": ...}`` line. A failing rank fails the phase;
4o. the rest of the host collectives (``phase_hostcoll``): the port's
   ``mpirun`` re-enters this script (``--child hostcoll_rank JOB``) for 4
   ranks over ``self,sm`` at the default selection, and 3 over the plain
   tcp stream with ``quant_enable`` (int8 codes, then fp8) and with it on
   every rank but rank 1, all sharing the card. Each rank makes
   integer-valued f32 and bf16 payloads of 4 KB and 64 MB on the card
   from a seeded generator (and every peer's); every send stages from the
   card, every receive lands in a ``DeviceBuffer``. On the sm job's world
   coll/sm serves Barrier, Bcast, Allreduce (SUM and MAX, f32 and bf16),
   Reduce, Allgather, Gather, Scatter and Alltoall, and hands an Alltoall
   whose bytes do not divide to its flat module (off ``x86_64`` its
   decline is required and the machine printed); rank 0 times a 64 MB
   Allreduce 3 times through sm and through tuned; on a Dup under
   ``coll_hier_fake_nodes=2`` hier composes Allreduce, Bcast, Allgather
   and Reduce_scatter_block (its plan and stages printed); on a Dup under
   ``coll_han_fake_nodes=2``, ``coll_hier_enable=0`` and
   ``coll_adapt_enable=1`` han serves Allreduce and Barrier, adapt Bcast
   and Reduce, and sm declines by its own rule. Exact results are held
   against their closed form on the card bit for bit; the quantized
   Allreduce, Allgather and Reduce_scatter_block within the codec's bound
   of the exact sum on the card, with the quant counters grown as the
   reference counts; in the fallback job every rank falls back together,
   exact. Each call's component is printed; the 64 MB Allreduce's host ms
   and the phase's seconds with the card; one ``{"hostcoll": ...}`` line.
   A failing rank, or a call served by another component than the
   selection should give, fails the phase;
6. one JSON line describing every kernel, then the device JSON line last.

Without a CUDA device, or outside a checkout, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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


TYPED_ROWS = 4096  # 64 MB of packed payload a case, the size of 4f and 4g
TYPED_FRAGS = (64 << 10, 1 << 20)
TYPED_EXTERNAL = (("float32", ">f4"), ("float64", ">f8"),
                  ("complex64", ">c8"))
TYPED_PARK_US = 3_000_000  # the idle-block cap of the progress checks


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def typed_cases(R, device, gen):
    """Phase 4j's cases at ``R`` rows (4096: 64 MB packed each, 4f's size),
    from ``gen``: name -> (tensor on ``device``, its datatype, count, the
    byte offset of the first element, the index ``sel`` that selects the
    same elements on the device)."""
    import numpy as np

    from ompi_tpu_torch.core import datatype as D

    C, all_ = 2 * R, slice(None)
    vec = D.FLOAT32.Create_vector(R, 1, 2).Create_resized(0, C * 4)
    r0, c0 = R // 2, R // 4 + 3
    # the [R, R] block at (r0, c0) of a [C, C] matrix: the subarray of one
    # row's columns [c0, c0 + R), R rows from row r0
    sub = D.FLOAT32.Create_subarray([C], [R], [c0])
    n_pairs = R * R // 2
    v = torch.rand(n_pairs, generator=gen, device=device)
    i = torch.randint(-2**31, 2**31 - 1, (n_pairs,), generator=gen,
                      device=device, dtype=torch.int32)
    n_dint = R * R * 4 // 12
    dint = torch.randint(-2**31, 2**31 - 1, (n_dint, 4), generator=gen,
                         device=device, dtype=torch.int32)
    dint[:, :2] = torch.rand(n_dint, generator=gen, device=device,
                             dtype=torch.float64).view(torch.int32).view(
                                 n_dint, 2)
    # 64 blocks (fewer below 256 rows) of seeded lengths summing to R, each
    # followed by a gap of its own length
    rng = np.random.default_rng(11)
    n_blocks = min(64, R // 4)
    cuts = np.sort(rng.choice(np.arange(1, R), n_blocks - 1, replace=False))
    lens = np.diff(np.concatenate([[0], cuts, [R]])).tolist()
    disps = (2 * np.concatenate([[0], np.cumsum(lens)[:-1]])).tolist()
    idx = torch.cat([torch.arange(d, d + n) for d, n in zip(disps, lens)])
    half = D.BFLOAT16.Create_vector(C, 1, 2).Create_resized(0, 2 * C * 2)
    return {
        "vector": (torch.rand(R, C, generator=gen, device=device), vec, R,
                   0, (all_, slice(None, None, 2))),
        "subarray": (torch.rand(C, C, generator=gen, device=device), sub, R,
                     r0 * C * 4, (slice(r0, r0 + R), slice(c0, c0 + R))),
        "float_int": (torch.stack([v.view(torch.int32), i], 1), D.FLOAT_INT,
                      n_pairs, 0, (all_, all_)),
        # DOUBLE_INT's extent is its 12 bytes; resized to the 16 of an
        # array of C structs {double; int;} it leaves a 4-byte hole
        "double_int": (dint, D.DOUBLE_INT.Create_resized(0, 16), n_dint, 0,
                       (all_, slice(0, 3))),
        "indexed": (torch.randint(-2**31, 2**31 - 1, (R, C), generator=gen,
                                  device=device, dtype=torch.int32),
                    D.INT32.Create_indexed(lens, disps).Create_resized(
                        0, C * 4), R, 0, (all_, idx.to(device))),
        "resized": (torch.rand(R * R // 2, 3, generator=gen, device=device,
                               dtype=torch.float64),
                    D.FLOAT64.Create_resized(0, 24), R * R // 2, 0,
                    (all_, 0)),
        "bf16_vector": (torch.randn(R, 2 * C, generator=gen, device=device,
                                    dtype=torch.bfloat16), half, R, 0,
                        (all_, slice(None, None, 2))),
        "fp16_vector": (torch.randn(R, 2 * C, generator=gen, device=device,
                                    dtype=torch.float16),
                        D.FLOAT16.Create_vector(C, 1, 2).Create_resized(
                            0, 2 * C * 2), R, 0,
                        (all_, slice(None, None, 2))),
    }


def _typed_case(name, t, dt, count, offset, sel, device, sync, rng):
    """One case of phase 4j: stage, pack (native and numpy), check against
    the device's selection, unpack, drain with a Convertor out of order
    (the send side: the receive side's fragments are the card tests')."""
    import numpy as np

    from ompi_tpu_torch.accelerator import get_module, stage_to_host
    from ompi_tpu_torch.core import convertor as cv

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    total = count * dt.size
    # bf16 stages through an int16 view: stage_to_host refuses bf16
    view = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    host, d2h_s = timed(lambda: stage_to_host(view))
    src = host.reshape(-1).view(np.uint8)[offset:]
    native = cv._NATIVE_MIN_BYTES
    p_native, pack_s = timed(lambda: cv.pack(src, count, dt))
    cv._NATIVE_MIN_BYTES = 1 << 62
    try:
        p_numpy, np_pack_s = timed(lambda: cv.pack(src, count, dt))
        require(np.array_equal(p_native, p_numpy),
                f"typed {name}: the native pack equals the numpy path's")
        del p_numpy
        dst_np = np.zeros(host.nbytes, np.uint8)
        _, np_unpack_s = timed(
            lambda: cv.unpack(p_native, dst_np[offset:], count, dt))
    finally:
        cv._NATIVE_MIN_BYTES = native
    require(p_native.nbytes == total, f"typed {name}: {p_native.nbytes} "
            f"packed bytes, {total} expected")
    # a contiguous type packs to a borrowed view of the read-only staged
    # array: copy it first (untimed), torch warns on a read-only source
    h2d_src = p_native if p_native.flags.writeable else p_native.copy()
    # .to(t.device): a no-op on the card; where the CPU rehearses this on
    # a host with a card, the accelerator module copies to the card
    packed_dev, h2d_s = timed(
        lambda: get_module().mem_copy_to_device(h2d_src).to(t.device))
    require(torch.equal(packed_dev, _bytes(t[sel])),
            f"typed {name}: the packed bytes equal the device's selection")
    gather_ms = time_ms(lambda: t[sel].contiguous(), iters=10, warmup=2,
                        device=device)
    dst = np.zeros(host.nbytes, np.uint8)
    _, unpack_s = timed(lambda: cv.unpack(p_native, dst[offset:], count, dt))
    require(np.array_equal(dst, dst_np),
            f"typed {name}: the native unpack equals the numpy path's")
    del dst_np
    masked = torch.zeros_like(t)
    masked[sel] = t[sel]
    require(torch.equal(get_module().mem_copy_to_device(dst).to(t.device),
                        _bytes(masked)),
            f"typed {name}: the unpacked buffer equals the masked copy")
    frag_gbs = {}
    for frag in TYPED_FRAGS:
        starts = rng.permutation(np.arange(0, total, frag))
        out = np.empty(total, np.uint8)
        conv = cv.Convertor(src, count, dt, for_send=True)

        def drain():
            for s in starts:
                conv.set_position(int(s))
                out[s:s + frag] = conv.pack_frag(frag)

        _, frag_s = timed(drain)
        require(np.array_equal(out, p_native),
                f"typed {name}: {frag >> 10} KB fragments out of order "
                f"equal the whole pack")
        frag_gbs[frag] = total / frag_s / 1e9
    gbs = lambda s: round(total / s / 1e9, 3)  # noqa: E731
    return {"packed_bytes": total, "native_pack_gbs": gbs(pack_s),
            "numpy_pack_gbs": gbs(np_pack_s),
            "native_unpack_gbs": gbs(unpack_s),
            "numpy_unpack_gbs": gbs(np_unpack_s),
            "frag_64k_pack_gbs": round(frag_gbs[TYPED_FRAGS[0]], 3),
            "frag_1m_pack_gbs": round(frag_gbs[TYPED_FRAGS[1]], 3),
            "d2h_gbs": round(host.nbytes / d2h_s / 1e9, 3),
            "h2d_gbs": gbs(h2d_s), "gather_ms": round(gather_ms, 4)}


def typed_progress() -> dict:
    """The progress engine on this host: a parked ``progress_until`` woken
    by a socketpair write, then by ``poke``; a ``ProgressThread`` that parks
    and stops; ``Grequest`` and ``Prequest`` completion."""
    import socket
    import threading

    from ompi_tpu_torch.core.request import Grequest, Prequest
    from ompi_tpu_torch.mca.var import all_pvars, get_var, set_var
    from ompi_tpu_torch.runtime import progress as P

    tx, rx = socket.socketpair()
    rx.setblocking(False)
    got = []

    def drain() -> int:
        try:
            data = rx.recv(4096)
        except BlockingIOError:
            return 0
        got.append(data)
        return 1

    blocks = lambda: all_pvars()["runtime_progress_idle_blocks"].value  # noqa: E731
    cap = get_var("runtime", "idle_block_us")
    P.register_progress(drain)
    P.set_idle_sources([lambda: ([rx.fileno()], [])])
    set_var("runtime", "idle_block_us", TYPED_PARK_US)
    out = {}
    try:
        b0 = blocks()
        timer = threading.Timer(0.2, lambda: tx.send(b"wake"))
        timer.start()
        t0 = time.perf_counter()
        ok = P.progress_until(lambda: bool(got), timeout=10)
        out["frame_wake_s"] = round(time.perf_counter() - t0, 4)
        timer.join()
        require(ok and got == [b"wake"] and out["frame_wake_s"] < 1.5
                and blocks() > b0,
                f"progress: a parked progress_until woken by a frame "
                f"({out['frame_wake_s']} s)")
        flag = []
        timer = threading.Timer(0.2, lambda: (flag.append(1), P.poke()))
        timer.start()
        t0 = time.perf_counter()
        ok = P.progress_until(lambda: bool(flag), timeout=10)
        out["poke_wake_s"] = round(time.perf_counter() - t0, 4)
        timer.join()
        require(ok and out["poke_wake_s"] < 1.5,
                f"progress: poke wakes a parked wait ({out['poke_wake_s']} s)")
        b0 = blocks()
        pt = P.ProgressThread()
        pt.start()
        thread = pt._thread
        time.sleep(0.6)
        t0 = time.perf_counter()
        pt.stop()
        out["thread_stop_s"] = round(time.perf_counter() - t0, 4)
        require(not thread.is_alive() and out["thread_stop_s"] < 1.0
                and blocks() > b0,
                f"progress: a parked ProgressThread stops "
                f"({out['thread_stop_s']} s)")
        g = Grequest()
        timer = threading.Timer(0.1, g.Complete)
        timer.start()
        t0 = time.perf_counter()
        g.Wait(timeout=10)
        out["grequest_wait_s"] = round(time.perf_counter() - t0, 4)
        timer.join()
        fired = []
        p = Prequest(lambda r: (fired.append(1), r._set_complete(0)))
        for _ in range(2):
            p.Start()
            p.Wait(timeout=10)
        require(g.is_complete and fired == [1, 1] and p.is_complete,
                "progress: Grequest and Prequest complete")
    finally:
        set_var("runtime", "idle_block_us", cap)
        P.set_idle_sources([])
        P.unregister_progress(drain)
        tx.close()
        rx.close()
    return out


def phase_typed(card, device="cuda", rows=TYPED_ROWS):
    """Phase 4j: typed buffers on the card. CUDA tensors staged to the
    host, packed and unpacked through the datatype engine (the native runs
    engine and the numpy path, bit-equal), held against a torch expression
    on the card that selects the same elements; Convertor fragments out of
    order; external32 against numpy's big-endian ``astype``; then the
    progress engine on this host."""
    import numpy as np

    from ompi_tpu_torch import native
    from ompi_tpu_torch.accelerator import stage_to_host
    from ompi_tpu_torch.core import datatype as D
    from ompi_tpu_torch.core import external32 as x32

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    lib_path = native.library_path()
    fresh = not lib_path.exists()
    tb = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - tb
    print(f"typed: native engine {lib_path} "
          f"{'built' if fresh else 'reused'} in {build_s:.2f} s", flush=True)
    gen = torch.Generator(device=device).manual_seed(11)
    rng = np.random.default_rng(11)
    cases = {}
    for name, (t, dt, count, offset, sel) in typed_cases(
            rows, device, gen).items():
        dt.Commit()
        cases[name] = _typed_case(name, t, dt, count, offset, sel, device,
                                  sync, rng)
        del t
    external = {}
    n = rows * rows  # 64 MB of f32 at 4096 rows
    for name, big in TYPED_EXTERNAL:
        tdt = getattr(torch, name)
        t = torch.randn(n * 4 // tdt.itemsize, generator=gen, device=device,
                        dtype=tdt)
        host = stage_to_host(t)
        out = np.empty(host.nbytes, np.uint8)
        dt = D.from_numpy_dtype(tdt)
        ts = time.perf_counter()
        end = x32.pack_external("external32", host, host.size, dt, out, 0)
        secs = time.perf_counter() - ts
        require(end == host.nbytes and out.tobytes() ==
                host.astype(big).tobytes(),
                f"typed: external32 {name} equals numpy's {big} astype")
        external[name] = round(host.nbytes / secs / 1e9, 3)
    progress = typed_progress()
    secs = time.perf_counter() - t0
    print(json.dumps({"typed_buffers": {
        "card": card, "rows": rows, "library": str(lib_path.name),
        "native_build_s": round(build_s, 3), "built": fresh, "cases": cases,
        "external32_pack_gbs": external, "progress": progress,
        "phase_s": round(secs, 1)}}), flush=True)
    print(f"phase 4j: {len(cases)} cases bit-equal native/numpy/device at "
          f"{rows * rows * 4 >> 20} MB packed each, external32 of "
          f"{len(external)} types, the progress engine, {secs:.1f} s on "
          f"{card}", flush=True)


# phase 4k: the diagnostic and fault planes beside the card
DIAG_IVERBS = ("allreduce", "bcast", "reduce", "allgather", "alltoall",
               "reduce_scatter", "allreduce", "bcast")  # 8 i-verbs
DIAG_REPS = 5  # i-verb calls timed behind queued work, a setting
DIAG_HOOK_CALLS = 20000
DIAG_EXPORT_REPS = 5
PROM_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')


def bind_child(rank: int = 3, size: int = COMM_W) -> int:
    """4k's child: ``bind_rank`` in a fresh process, its affinity read
    back, as a JSON line."""
    import os

    from ompi_tpu_torch.runtime import topology

    got = topology.bind_rank(rank, size)
    print(json.dumps({"rank": rank, "size": size, "cpus": got,
                      "affinity": sorted(os.sched_getaffinity(0))}),
          flush=True)
    return 0


def _sysfs_nodes():
    """{node id: cpus} read from /sys/devices/system/node on their own
    terms (not through the module under test); {} where there is none."""
    import os

    root = "/sys/devices/system/node"
    out = {}
    if not os.path.isdir(root):
        return out
    for name in os.listdir(root):
        if not (name.startswith("node") and name[4:].isdigit()):
            continue
        cpus = set()
        with open(os.path.join(root, name, "cpulist")) as f:
            for part in f.read().strip().split(","):
                if part:
                    lo, _, hi = part.partition("-")
                    cpus.update(range(int(lo), int(hi or lo) + 1))
        out[int(name[4:])] = sorted(cpus)
    return out


def diag_topology(card, device):
    """4k.1: the host topology beside the card."""
    import os

    from ompi_tpu_torch.runtime import topology

    topo = topology.discover()
    allowed = sorted(os.sched_getaffinity(0))
    require(topo.allowed_cpus == allowed,
            f"discover()'s allowed cpus are the affinity mask ({topo.ncpus} "
            f"vs {len(allowed)})")
    nodes = _sysfs_nodes()
    if nodes:
        got = {n.id: sorted(n.cpus) for n in topo.numa}
        require(got == nodes, f"discover()'s NUMA nodes are sysfs's: {got} "
                              f"vs {nodes}")
    require(all(topo.numa_of_cpu(c) >= 0 for c in allowed),
            "every allowed cpu lies on a NUMA node")
    acc = topo.accelerators()
    if device == "cuda":
        name = card.split(",")[0].strip()
        require(len(acc) == torch.cuda.device_count()
                and acc[0]["kind"] == name,
                f"accelerators() names the card as nvidia-smi does: {acc}")
    else:
        require(acc == topology.accelerators(), "accelerators() on the host")
    sets = [topology.rank_cpuset(r, COMM_W, topo) for r in range(COMM_W)]
    require(all(sets), "rank_cpuset gives every rank of 8 a cpu")
    require(sorted(set().union(*map(set, sets))) == allowed,
            "the 8 ranks' cpusets cover the allowed set")
    if topo.ncpus >= COMM_W:
        require(sum(map(len, sets)) == len(set().union(*map(set, sets))),
                "the 8 ranks' cpusets are disjoint")
    p = subprocess.run([sys.executable, __file__, "--child", "bind_rank"],
                       capture_output=True, text=True, timeout=120)
    require(p.returncode == 0, f"the bind_rank child exits 0: {p.stderr}")
    child = json.loads(p.stdout.strip().splitlines()[-1])
    require(child["cpus"] == child["affinity"] == sets[child["rank"]],
            f"bind_rank's affinity reads back in the child: {child}")
    print("topology: " + topo.summary().replace("\n", " |"), flush=True)
    return {"ncpus": topo.ncpus, "numa_nodes": len(topo.numa),
            "rank_cpus": [len(s) for s in sets],
            "accelerators": [a["kind"] for a in acc]}


def parse_prometheus(text):
    """{(name, labels text): value} of every sample of an exposition."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = PROM_SAMPLE.match(line)
        require(m is not None, f"a Prometheus sample line: {line!r}")
        key = (m.group(1), m.group(2) or "")
        require(key not in out, f"one sample a series: {key}")
        out[key] = float(m.group(3))
    return out


def prom_expected(metrics, snap):
    """The samples ``render_prometheus([snap])`` must hold, from the
    snapshot's own values."""
    base = {"rank": snap["rank"]}
    want = {}
    for c, v in snap["counters"].items():
        want[("ompi_spc_" + metrics._prom_name(c),
              metrics._prom_labels(base))] = float(v)
    for p, v in snap["pvars"].items():
        if isinstance(v, (bool, int, float)):
            want[("ompi_pvar_" + metrics._prom_name(p),
                  metrics._prom_labels(base))] = float(v)
    for g in snap["gauges"]:
        want[("ompi_metrics_" + metrics._prom_name(g["name"]),
              metrics._prom_labels(dict(base, **g["labels"])))] = g["value"]
    for e in snap["ewmas"]:
        want[("ompi_metrics_" + metrics._prom_name(e["name"]) + "_ewma",
              metrics._prom_labels(dict(base, **e["labels"])))] = e["value"]
    for h in snap["histograms"]:
        name = "ompi_metrics_" + metrics._prom_name(h["name"])
        lbl = dict(base, **h["labels"])
        want[(name + "_count", metrics._prom_labels(lbl))] = h["count"]
        want[(name + "_sum", metrics._prom_labels(lbl))] = h["sum"]
        want[(name + "_bucket", metrics._prom_labels(dict(lbl, le="+Inf")))] \
            = h["count"]
    return want


def _per_call_us(fn, n):
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t0) / n


def diag_metrics(card, dev, device, scale, quant_sizes, tmp):
    """4k.2: the metrics plane over phase 4i's sequence on ``dev``."""
    import os

    from ompi_tpu_torch.coll import mesh as coll_mesh
    from ompi_tpu_torch.mca.var import set_var
    from ompi_tpu_torch.runtime import metrics, spc
    from ompi_tpu_torch.tools import bench

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    set_var("metrics", "enable", True)
    set_var("metrics", "dir", tmp)
    metrics.reset_for_testing()
    spc.reset()
    inputs = obs_inputs(device, scale=scale)
    outs, calls = obs_sequence(dev, *inputs)
    sync()
    del outs
    snap = metrics.snapshot()
    require(snap["counters"] == spc.snapshot() == calls,
            f"snapshot()'s counters {snap['counters']} are spc's, the "
            f"calls {calls}")
    st = coll_mesh.stats
    mesh_pvars = {k: snap["pvars"].get("coll_mesh_" + k)
                  for k in ("cache_hits", "cache_misses", "compile_time_us")}
    require(mesh_pvars == {"cache_hits": st.hits, "cache_misses": st.misses,
                           "compile_time_us": st.compile_ns // 1000},
            f"the snapshot's mesh cache pvars {mesh_pvars} are coll/mesh.py's"
            f" stats")
    # the bench legs at the bench's own sizes, their rows in the gauges
    qrows = bench.bench_quant_sweep(dev, COMM_W, **(
        {} if quant_sizes is None else {"sizes": quant_sizes}))
    tax = bench.bench_dispatch_tax(dev)
    require(all("skipped" not in r for r in qrows), f"quant sweep: {qrows}")
    for r in qrows:
        require(metrics.gauge_get("bench_quant_fraction", bytes=r["bytes"])
                == r["fraction"]
                and metrics.gauge_get("bench_quant_err_vs_bound",
                                      bytes=r["bytes"])
                == r["max_err_vs_bound"],
                f"the quant gauges at {r['bytes']} B are the row's")
    require(metrics.gauge_get("bench_prologue_us") == tax["prologue_us"]
            and metrics.gauge_get("bench_dispatch_overhead_us")
            == tax["overhead_us"]
            and all(metrics.gauge_get("bench_layer_overhead_us", verb=v)
                    == d["layer_overhead_us"]
                    for v, d in tax["verb_sweep"].items()),
            "the dispatch-tax gauges are the row's")
    for v in (3.0, 700.0, 2.5e5):
        metrics.observe("phase4k_hook_us", v, verb="allreduce")
    metrics.ewma_update("phase4k_ewma", 12.5)
    snap = metrics.snapshot()
    text = metrics.render_prometheus([snap])
    samples = parse_prometheus(text)
    want = prom_expected(metrics, snap)
    missing = {k: v for k, v in want.items() if samples.get(k) != v}
    require(not missing, f"the Prometheus render parses back to the "
                         f"snapshot: {list(missing.items())[:4]}")
    path = metrics.export_json(os.path.join(tmp, "metrics-rank0.json"))
    after = metrics.snapshot()
    with open(path) as f:
        doc = json.load(f)
    for key in ("rank", "counters", "gauges", "histograms", "ewmas"):
        require(doc[key] == json.loads(json.dumps(after[key], default=str)),
                f"export_json round-trips {key}")
    require(sorted(doc["pvars"]) == sorted(after["pvars"]),
            "export_json round-trips the pvar names")

    timings = {}
    for on in (True, False):
        set_var("metrics", "enable", on)
        tag = "enabled" if on else "disabled"

        def obs():
            if metrics._enable_var._value:
                metrics.observe("phase4k_hook_us", 5.0, verb="allreduce")

        def gset():
            if metrics._enable_var._value:
                metrics.gauge_set("phase4k_gauge", 1.0, verb="allreduce")

        timings[f"observe_us_{tag}"] = _per_call_us(obs, DIAG_HOOK_CALLS)
        timings[f"gauge_set_us_{tag}"] = _per_call_us(gset, DIAG_HOOK_CALLS)
    set_var("metrics", "enable", True)
    for name, fn in (("snapshot_ms", metrics.snapshot),
                     ("render_prometheus_ms", metrics.render_prometheus),
                     ("export_json_ms", lambda: metrics.export_json(path))):
        ts = []
        for _ in range(DIAG_EXPORT_REPS):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        timings[name] = sorted(ts)[len(ts) // 2]
    n = len(metrics.snapshot()["gauges"])
    print(f"metrics: snapshot counters = spc {calls}; mesh cache pvars "
          f"{mesh_pvars}; {len(qrows)} quant rows and {len(tax['verb_sweep'])}"
          f" verbs in {n} gauges; {len(samples)} Prometheus samples parse "
          f"back; export_json round-trips; {timings} on {card}", flush=True)
    return dict(timings, prometheus_samples=len(samples), gauges=n)


def _iverbs(dev, x, blocks):
    """The 8 i-verbs of 4k.3 on ``x`` ([W, n]) and ``blocks`` ([W, W, n/W])."""
    from ompi_tpu_torch.core.op import SUM

    args = {"allreduce": (x,), "bcast": (x, COMM_ROOT),
            "reduce": (x, SUM, COMM_ROOT), "allgather": (x,),
            "alltoall": (blocks,), "reduce_scatter": (blocks,)}
    return [getattr(dev, "i" + v)(*args[v]) for v in DIAG_IVERBS]


def diag_requests(card, dev, device, scale, tmp):
    """4k.3: forensics and the sanitizer on the card's requests."""
    import os

    from ompi_tpu_torch.core import request as core_request
    from ompi_tpu_torch.mca.var import all_pvars, set_var
    from ompi_tpu_torch.runtime import forensics, sanitizer

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gen = torch.Generator(device).manual_seed(12)
    x = torch.randn((COMM_W, ASYNC_ELEMS // scale), device=device,
                    generator=gen)
    blocks = x.view(COMM_W, COMM_W, -1)
    # both planes off: the reference results
    plain = [r.result for r in _iverbs(dev, x, blocks)]
    sync()

    set_var("metrics", "dir", tmp)
    set_var("forensics", "enable", True)
    require(core_request._fx_note is forensics.note_completion,
            "forensics_enable binds the completion tick")
    base = forensics._completions[0]
    reqs = _iverbs(dev, x, blocks)
    for r in reqs:
        r.Wait()
    ticks = forensics._completions[0] - base
    require(ticks == len(DIAG_IVERBS),
            f"8 Waits tick the completion counter by 8 ({ticks})")
    require(all(torch.equal(r.result, p) for r, p in zip(reqs, plain)),
            "the i-verbs under forensics are bit-equal to the plain ones")
    del reqs
    dumps0 = all_pvars()["forensics_dumps"].value
    expected = {n for n, fn in forensics._providers.items() if fn() is not None}
    path = forensics.dump(reason="chip_smoke phase 4k")
    require(path == os.path.join(tmp, "stall-rank0.json"),
            f"dump() writes under metrics_dir ({path})")
    with open(path) as f:
        doc = json.load(f)
    require("runtime.progress" in doc["subsystems"]
            and set(doc["subsystems"]) == expected,
            f"the dump holds every provider: {sorted(doc['subsystems'])} vs "
            f"{sorted(expected)}")
    require(all_pvars()["forensics_dumps"].value == dumps0 + 1,
            "the forensics_dumps pvar counts the dump")
    set_var("forensics", "enable", False)
    require(core_request._fx_note is None, "forensics off unbinds the tick")

    sanitizer.enable(level=2)
    try:
        waited = dev.iallreduce(x)
        waited.Wait()
        leaks = []
        if cuda:
            cycles = _sleep_cycles(ASYNC_SLEEP_MS)
            sync()
            torch.cuda._sleep(cycles)
            pending = dev.iallreduce(x)
            leaks = sanitizer.check_leaks()
            require([r for r, _ in leaks] == [pending],
                    f"check_leaks() names exactly the pending i-verb "
                    f"({len(leaks)} named)")
            require("chip_smoke" in (leaks[0][1] or ""),
                    "with its creation backtrace")
            pending.Wait()
            require(torch.equal(pending.result, plain[0]),
                    "the pending i-verb under the sanitizer is bit-equal")
        require(sanitizer.check_leaks() == [], "after its Wait: no leak")
        require(torch.equal(waited.result, plain[0]),
                "the i-verb under the sanitizer is bit-equal")
        del waited
    finally:
        sanitizer.disable()

    # the i-verb's host time behind queued device work, in three settings
    host_us = {}
    if cuda:
        cycles = _sleep_cycles(ASYNC_SLEEP_MS)
        for setting in ("off", "forensics", "sanitizer_level2"):
            if setting == "forensics":
                set_var("forensics", "enable", True)
            elif setting == "sanitizer_level2":
                sanitizer.enable(level=2)
            try:
                ts = []
                for _ in range(DIAG_REPS):
                    sync()
                    torch.cuda._sleep(cycles)
                    t0 = time.perf_counter()
                    req = dev.iallreduce(x)
                    ts.append(1e6 * (time.perf_counter() - t0))
                    require(not req.Test(), "the i-verb waits behind the "
                                            "queued sleep")
                    req.Wait()
                host_us[setting] = sorted(ts)[len(ts) // 2]
            finally:
                set_var("forensics", "enable", False)
                sanitizer.disable()
    print(f"requests: {ticks} completion ticks for {len(DIAG_IVERBS)} "
          f"i-verbs at {ASYNC_ELEMS // scale * 4} B a rank, bit-equal to the "
          f"plain ones; dump {os.path.basename(path)} with "
          f"{len(doc['subsystems'])} providers; the sanitizer named "
          f"{len(leaks)} pending i-verb(s), then none; i-verb host us behind "
          f"{ASYNC_SLEEP_MS:.0f} ms of queued work {host_us} on {card}",
          flush=True)
    return {"completion_ticks": ticks, "dump_providers": len(doc["subsystems"]),
            "pending_named": len(leaks),
            "iverb_host_us_behind_queued_work": host_us}


def phase_diagnostics(card, device="cuda", scale=1, quant_sizes=None):
    """Phase 4k: the diagnostic and fault planes that process mode stands
    on, beside the card: the host topology (NUMA, rank cpusets, binding in
    a child, the card in the accelerator inventory); the metrics plane over
    phase 4i's sequence on ``mesh_world(8)`` and the bench's gauges, its
    Prometheus render and JSON export; forensics' completion tick and dump
    and the sanitizer's leak check on the card's i-verb requests, with the
    i-verb's host time behind queued work in each setting. ``qos``,
    ``ft/inject``, ``linkmodel``, the detector and ``revoke`` ride the tcp
    btl's wire, which phase 4l drives.
    ``device="cpu"`` with a ``scale`` rehearses the phase on the host,
    where every request completes when its verb returns, so the pending
    request and the timings behind queued work are left out."""
    import shutil
    import tempfile

    import ompi_tpu_torch.ft.detector  # noqa: F401 a forensics provider
    from ompi_tpu_torch.mca.var import get_var, set_var
    from ompi_tpu_torch.parallel.mesh import mesh_world
    from ompi_tpu_torch.runtime import metrics

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_diag_")
    saved = {n: get_var(*n) for n in (("metrics", "enable"),
                                      ("metrics", "dir"))}
    try:
        out = {"topology": diag_topology(card, device)}
        dev = mesh_world(COMM_W, device)
        out["metrics"] = diag_metrics(card, dev, device, scale, quant_sizes,
                                      tmp)
        out["requests"] = diag_requests(card, dev, device, scale, tmp)
    finally:
        for n, v in saved.items():
            set_var(*n, v)
        metrics.reset_for_testing()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card
    print(json.dumps({"diagnostics": out}), flush=True)
    print(f"phase 4k: {out['seconds']:.1f} s on {card}", flush=True)
    return out


# phase 4l: the byte transfer layer beside the card
BTL_PAYLOADS = (("f32", torch.float32, 64 << 20),
                ("bf16", torch.bfloat16, 64 << 20),
                ("int8", torch.int8, 16 << 20),
                ("zeros_f32", torch.float32, 64 << 20))
BTL_TCP_FRAG = 1 << 20        # ob1's default rendezvous fragment
BTL_PIPELINE_DEPTH = 16 << 20  # ob1's default unacked bytes in flight
BTL_CALLS = 2                 # a first and a second call of every path
BTL_CORRUPT = "corrupt(0,1,nth=7)"
BTL_DEADLINE_S = 120.0        # a transfer not done by then fails the phase
BTL_TCP_MODES = {"tcp": {}, "tcp_legacy": {"reliable": 0},
                 "tcp_compressed": {"compress": 1}}
BTL_SM_MODES = {"sm": {"use_native": 1}, "sm_python": {"use_native": 0}}


def btl_payloads(device, scale, gen):
    """Phase 4l's payloads on ``device`` from ``gen``: name -> tensor (f32
    and bf16 of 64 MB, int8 of 16 MB and 64 MB of f32 zeros, each divided
    by ``scale``)."""
    out = {}
    for name, dtype, nbytes in BTL_PAYLOADS:
        n = nbytes // scale // torch.tensor([], dtype=dtype).element_size()
        if name.startswith("zeros"):
            out[name] = torch.zeros(n, dtype=dtype, device=device)
        elif dtype.is_floating_point:
            out[name] = torch.randn(n, generator=gen, device=device,
                                    dtype=dtype)
        else:
            out[name] = torch.randint(-128, 128, (n,), generator=gen,
                                      device=device, dtype=dtype)
    return out


class _BtlSink:
    """A receiving end: each frame's payload lands at its header's byte
    offset in one buffer (a retransmitted frame may overtake another)."""

    def __init__(self, header_cls):
        self.header_cls = header_cls
        self.buf = np.empty(0, np.uint8)
        self.bytes = self.frames = 0

    def reset(self, nbytes):
        if self.buf.nbytes != nbytes:
            self.buf = np.empty(nbytes, np.uint8)
        self.buf.fill(0)
        self.bytes = self.frames = 0

    def deliver(self, hdr, payload):
        off = self.header_cls(bytes(hdr)).offset
        data = np.frombuffer(payload, np.uint8)
        self.buf[off:off + data.nbytes] = data
        self.bytes += data.nbytes
        self.frames += 1


def _btl_drive(send, peer, btls, sink, host, frag, pml, depth):
    """Send ``host`` (read-only uint8) to ``peer`` in frames of ``frag``
    bytes, at most ``depth`` bytes ahead of what has arrived (ob1's flow
    control), and progress ``btls`` until ``sink`` holds all of it; the
    host seconds. Past ``BTL_DEADLINE_S`` the phase fails."""
    n = host.nbytes
    sink.reset(n)
    t0 = time.perf_counter()
    offs = list(range(0, n, frag))
    i = 0
    while sink.bytes < n:
        while i < len(offs) and offs[i] - sink.bytes < depth:
            off = offs[i]
            send(peer, pml.pack_header(pml.EAGER, 0, 0, 4400, i + 1, n, off,
                                       0), host[off:off + frag])
            i += 1
        for b in btls:
            b.progress()
        require(time.perf_counter() - t0 < BTL_DEADLINE_S,
                f"btl: {n} bytes delivered within {BTL_DEADLINE_S:.0f} s "
                f"({sink.bytes} arrived)")
    secs = time.perf_counter() - t0
    require(sink.bytes == n, f"btl: exactly {n} bytes delivered")
    # a live progress engine drains the acks: the sender's retransmit
    # window empties before the next transfer
    conns = [c for b in btls for c in getattr(b, "conns", {}).values()]
    while any(c.retx for c in conns):
        for b in btls:
            b.progress()
        require(time.perf_counter() - t0 < BTL_DEADLINE_S,
                "btl: the retransmit window drains")
    return secs


def _btl_pump(btls, until, what):
    t0 = time.perf_counter()
    while not until():
        for b in btls:
            b.progress()
        require(time.perf_counter() - t0 < BTL_DEADLINE_S, what)


def _btl_path(kind, sink):
    """A sending btl, its peer rank, the btls to progress and their
    finalizers for path ``kind`` (self, tcp or sm), delivering to
    ``sink``."""
    from ompi_tpu_torch.btl.self_btl import SelfBtl
    from ompi_tpu_torch.btl.sm import SmBtl
    from ompi_tpu_torch.btl.tcp import TcpBtl
    from ompi_tpu_torch.pml.base import HDR_SIZE

    if kind == "self":
        b = SelfBtl(sink.deliver)
        return b, 0, [b]
    if kind.startswith("tcp"):
        a = TcpBtl(lambda h, p: None, my_rank=0)
        b = TcpBtl(sink.deliver, my_rank=1)
    else:
        a = SmBtl(lambda h, p: None, my_rank=0, n_ranks=2)
        b = SmBtl(sink.deliver, my_rank=1, n_ranks=2)
    a.set_peers({1: f"127.0.0.1:{b.port}" if kind.startswith("tcp")
                 else b.seg_path})
    b.set_peers({0: f"127.0.0.1:{a.port}" if kind.startswith("tcp")
                 else a.seg_path})
    if kind.startswith("tcp"):
        # dial and take the acceptor's capability ack before any timed
        # frame: frames sent before it go out in the plain framing
        a.send(1, bytes(HDR_SIZE), b"")
        _btl_pump([a, b], lambda: not a.conns[1].await_ack and sink.frames,
                  "btl: the tcp handshake completes")
    return a, 1, [a, b]



def _btl_tcp_counters():
    from ompi_tpu_torch import quant
    from ompi_tpu_torch.mca.var import all_pvars

    pv = all_pvars()
    c = quant.counters()
    return {"copied": pv["btl_tcp_bytes_copied"].value,
            "writev": pv["btl_tcp_writev_calls"].value,
            "wire": pv["btl_tcp_wire_bytes"].value,
            "retransmits": pv["btl_tcp_retransmits"].value,
            "crc_errors": pv["btl_tcp_crc_errors"].value,
            "wire_raw": c["wire_raw"], "wire_comp": c["wire_comp"]}


def phase_btl(card, device="cuda", scale=1):
    """Phase 4l: the byte transfer layer beside the card. Payloads made on
    ``device`` from a seed (f32 and bf16 of 64 MB, int8 of 16 MB, 64 MB of
    f32 zeros), staged to the host through the accelerator component (bf16
    through its int16 view), sent through ``SelfBtl``, a ``TcpBtl`` pair
    (reliable, ``btl_tcp_reliable=0`` and ``btl_tcp_compress=1``) and an
    ``SmBtl`` pair (native ring and ``btl_sm_use_native=0``), as one frame
    (on sm the overflow file) and in fragments as ob1 would (1 MB on tcp,
    ``btl_sm_eager_limit`` on sm), twice; what arrives is uploaded to
    ``device`` and held against the original there, bit for bit. Fragments
    go out at most ob1's pipeline depth (16 MB) ahead of what arrived.
    Then the reliable pair under ``ft_inject_plan`` ``corrupt(0,1,nth=7)``,
    its retransmit window twice the stream: the 64 MB f32 stream heals
    bit-exact, with retransmits and no peer marked failed. ``device="cpu"`` with a ``scale`` rehearses the phase on the
    host (the sm ring and the fragments shrunk by the same factor, so that
    the one frame still takes the overflow path and the corrupted stream
    still has its 64 frames)."""
    import ompi_tpu_torch.btl.sm  # noqa: F401 registers btl_sm_*
    import ompi_tpu_torch.btl.tcp  # noqa: F401 registers btl_tcp_*
    from ompi_tpu_torch import native
    from ompi_tpu_torch.accelerator import stage_to_host
    from ompi_tpu_torch.ft import detector, inject
    from ompi_tpu_torch.mca.var import get_var, set_var
    from ompi_tpu_torch.pml import base as pml

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    lib_path = native.library_path()
    fresh = not lib_path.exists()
    tb = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - tb
    print(f"btl: native library {lib_path} "
          f"{'built' if fresh else 'reused'} in {build_s:.2f} s", flush=True)
    names = [("btl_tcp", k) for k in ("reliable", "compress",
                                      "retx_window_bytes")] + \
        [("btl_sm", k) for k in ("use_native", "ring_bytes")]
    saved = {n: get_var(*n) for n in names}
    ring_bytes = max(saved[("btl_sm", "ring_bytes")] // scale, 16 << 10)
    # ob1's sm fragment; a rehearsal's smaller ring takes smaller ones
    sm_frag = min(int(get_var("btl_sm", "eager_limit")), ring_bytes // 4)
    tcp_frag = max(BTL_TCP_FRAG // scale, 4096)
    depth = max(BTL_PIPELINE_DEPTH // scale, 2 * tcp_frag)
    gen = torch.Generator(device=device).manual_seed(13)
    payloads = btl_payloads(device, scale, gen)
    hosts, d2h = {}, {}
    for name, t in payloads.items():
        sync()
        ts = time.perf_counter()
        src = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        hosts[name] = stage_to_host(src).reshape(-1).view(np.uint8)
        d2h[name] = round(hosts[name].nbytes / (time.perf_counter() - ts)
                          / 1e9, 3)
    originals = {name: _bytes(t) for name, t in payloads.items()}
    sink = _BtlSink(pml.Header)
    gbs, counters, h2d = {}, {}, []
    paths = [("self", {})] + list(BTL_TCP_MODES.items()) + \
        list(BTL_SM_MODES.items())
    try:
        set_var("btl_sm", "ring_bytes", ring_bytes)
        for path, knobs in paths:
            fw = "btl_tcp" if path.startswith("tcp") else "btl_sm"
            for k, v in knobs.items():
                set_var(fw, k, v)
            before = _btl_tcp_counters()
            btl, peer, btls = _btl_path(path, sink)
            try:
                frag = tcp_frag if path.startswith("tcp") else sm_frag
                for framing, size in (("one_frame", None), ("fragments",
                                                            frag)):
                    for call in range(BTL_CALLS):
                        for name, host in hosts.items():
                            n = host.nbytes
                            if path.startswith("sm") and size is None:
                                require(n + 8 + pml.HDR_SIZE + 8 >
                                        ring_bytes - 192,
                                        "btl: the one frame takes sm's "
                                        "overflow path")
                            secs = _btl_drive(btl.send, peer, btls, sink,
                                              host, size or n, pml, depth)
                            ts = time.perf_counter()
                            got = torch.from_numpy(sink.buf).to(device)
                            sync()
                            h2d.append(n / (time.perf_counter() - ts) / 1e9)
                            require(torch.equal(got, originals[name]),
                                    f"btl: {name} through {path} "
                                    f"({framing}, call {call + 1}) arrives "
                                    "bit for bit")
                            gbs.setdefault(path, {}).setdefault(
                                framing, {}).setdefault(name, []).append(
                                round(n / secs / 1e9, 3))
            finally:
                for b in btls:
                    b.finalize()
                for k in knobs:
                    set_var(fw, k, saved[(fw, k)])
            if path.startswith("tcp"):
                after = _btl_tcp_counters()
                d = {k: after[k] - before[k] for k in after}
                counters[path] = {
                    "bytes_copied": d["copied"], "writev_calls": d["writev"],
                    "wire_bytes": d["wire"],
                    "copied_per_wire_byte": round(
                        d["copied"] / max(d["wire"], 1), 4),
                    "writev_calls_per_wire_mb": round(
                        d["writev"] / max(d["wire"], 1) * (1 << 20), 4)}
                if path == "tcp_compressed":
                    require(d["wire_comp"] > 0,
                            "btl: btl_tcp_compress=1 compressed frames")
                    counters[path]["compressed_wire_ratio"] = round(
                        d["wire_raw"] / d["wire_comp"], 3)
        # the reliable pair under a corrupting wire. The retransmit window
        # holds the stream: a hole keeps the cumulative ack behind while
        # the frames above it arrive, so ob1's pacing on delivered bytes
        # does not bound what is retained, and a smaller window (the
        # default 8 MB, or twice the pipeline depth) evicts a frame that
        # a NACK later asks for; the link then escalates
        before = _btl_tcp_counters()
        failed_before = detector.known_failed()
        set_var("btl_tcp", "retx_window_bytes", 2 * hosts["f32"].nbytes)
        inject.install(BTL_CORRUPT)
        btl, peer, btls = _btl_path("tcp", sink)
        try:
            host = hosts["f32"]
            secs = _btl_drive(btl.send, peer, btls, sink, host, tcp_frag,
                              pml, depth)
            got = torch.from_numpy(sink.buf).to(device)
            require(torch.equal(got, originals["f32"]),
                    f"btl: the f32 stream under {BTL_CORRUPT} heals bit "
                    "for bit")
            conns = [c for b in btls for c in b.conns.values()]
            require(all(c.dead is None and c.state == "est" for c in conns),
                    "btl: no link died under the corrupting wire")
        finally:
            inject.uninstall()
            for b in btls:
                b.finalize()
        after = _btl_tcp_counters()
        heal = {"retransmits": after["retransmits"] - before["retransmits"],
                "crc_errors": after["crc_errors"] - before["crc_errors"],
                "frames": sink.frames, "gbs": round(host.nbytes / secs / 1e9,
                                                    3)}
        require(heal["retransmits"] > 0 and heal["crc_errors"] > 0,
                f"btl: {BTL_CORRUPT} was caught by the CRC and retransmitted")
        require(detector.known_failed() == failed_before,
                "btl: no peer marked failed under the corrupting wire")
    finally:
        for n, v in saved.items():
            set_var(*n, v)
    secs = time.perf_counter() - t0
    out = {"card": card, "scale": scale, "library": lib_path.name,
           "native_build_s": round(build_s, 3), "built": fresh,
           "bytes": {n: h.nbytes for n, h in hosts.items()},
           "gbs": gbs, "tcp_counters": counters, "corrupt_heal": heal,
           "d2h_gbs": d2h, "h2d_gbs": [round(min(h2d), 3),
                                       round(max(h2d), 3)],
           "phase_s": round(secs, 1)}
    print(json.dumps({"btl": out}), flush=True)
    print(f"phase 4l: {len(hosts)} payloads bit-exact through "
          f"{len(paths)} paths, one frame and fragments, {BTL_CALLS} calls "
          f"each; {BTL_CORRUPT} healed with {heal['retransmits']} "
          f"retransmits; {secs:.1f} s on {card}", flush=True)
    return out


# ------------------------------------------------------ phase 4m: procmode
# the jobs of the port's own process mode on the card: (ranks, --mca pairs)
# (the btl selection variable is btl_btl; each job's btls are checked).
# The tcp job runs the plain stream (btl_tcp_reliable=0): on a busy host
# the reliable link's adaptive retransmit timer (a 25 ms floor) strikes
# while a receiver is still copying a 64 MB stream, the link degrades,
# and with more than btl_tcp_retx_window_bytes unacked the resync fails,
# in both packages alike (ROADMAP C); phase 4l drives the reliable link
PM_JOBS = ((4, (("btl_btl", "self,sm"),), "SmBtl"),
           (4, (("btl_btl", "self,tcp"), ("btl_tcp_reliable", "0")),
            "TcpBtl"),
           (3, (), "SmBtl"))
PM_SEED = 4242
PM_F32_BYTES = PM_BF16_BYTES = 64 << 20
PM_I8_BYTES = 16 << 20
PM_PINGPONG = (64 << 10, 1 << 20, 64 << 20)  # bytes, staged from the card
PM_LAT_ITERS = 200
PM_JOB_TIMEOUT_S = 150


def pm_payloads(rank, n, device, scale=1):
    """Rank ``rank``'s payloads of a job of ``n`` ranks, made on ``device``
    from a seeded generator: integer-valued f32 and bf16 (every sum and
    max below is exact) and int8 (sums wrap, as numpy's and torch's
    do). The element counts divide by ``n`` (``scale`` shrinks them for a
    rehearsal on the host)."""
    gen = torch.Generator(device=device).manual_seed(PM_SEED + rank)

    def count(nbytes, size):
        return nbytes // scale // size // n * n

    f32 = torch.randint(-1000, 1000, (count(PM_F32_BYTES, 4),),
                        generator=gen, device=device).to(torch.float32)
    bf16 = torch.randint(-8, 8, (count(PM_BF16_BYTES, 2),), generator=gen,
                         device=device).to(torch.bfloat16)
    i8 = torch.randint(-128, 128, (count(PM_I8_BYTES, 1),), generator=gen,
                       device=device, dtype=torch.int8)
    return {"f32": f32, "bf16": bf16, "i8": i8}


def _bits(t):
    """``t``'s bits as integers, for bit-for-bit comparisons on the card."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def _pm_sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def procmode_rank(device="cuda", scale=1) -> int:
    """One rank of phase 4m (``chip_smoke.py --child procmode_rank`` under
    the port's ``mpirun``). Every send stages from ``device``; every
    receive lands in a ``DeviceBuffer`` whose contents on ``device`` are
    held against the closed form there, bit for bit. Prints one
    ``PROCMODE-RANK {json}`` line; rank 0's carries the timings."""
    import ompi_tpu_torch as M
    from ompi_tpu_torch import COMM_WORLD as W
    from ompi_tpu_torch.accelerator import (DeviceBuffer, get_module,
                                            stage_to_host)
    from ompi_tpu_torch.core import op

    t_start = time.perf_counter()
    launched = float(os.environ.get("CHIP_SMOKE_PM_T0", time.time()))
    started = time.time() - launched  # interpreter, imports, Init
    r, n = W.Get_rank(), W.Get_size()
    if device == "cuda":
        require(get_module().NAME == "cuda",
                f"procmode rank {r}: the accelerator selected cuda")
    mine = pm_payloads(r, n, device, scale)
    every = [mine if q == r else pm_payloads(q, n, device, scale)
             for q in range(n)]
    checks = []

    def check(got_db, want, what):
        got = got_db.array if isinstance(got_db, DeviceBuffer) else got_db
        require(got.device.type == torch.device(device).type,
                f"procmode rank {r}: {what} lands on {device}")
        ok = got.dtype == want.dtype and got.shape == want.shape \
            and torch.equal(_bits(got), _bits(want))
        require(ok, f"procmode rank {r}: {what} bit-exact on {device}")
        checks.append(what)

    def recvbuf(like, numel=None):
        return DeviceBuffer((like.numel() if numel is None else numel,),
                            like.dtype)

    # the ring of examples/ring.py, the message a tensor on the card
    msg = torch.tensor([10 if r == 0 else 0], dtype=torch.int32,
                       device=device)
    nxt, prv = (r + 1) % n, (r - 1) % n
    laps = 0
    if r == 0:
        W.Send(msg, dest=nxt, tag=201)
    while True:
        db = DeviceBuffer((1,), torch.int32)
        W.Recv(db, source=prv, tag=201)
        msg = db.array
        if r == 0:
            msg = msg - 1
            laps += 1
        W.Send(msg, dest=nxt, tag=201)
        if int(msg[0]) == 0:
            break
    if r == 0:
        db = DeviceBuffer((1,), torch.int32)
        W.Recv(db, source=prv, tag=201)
        require(laps == 10, f"procmode: the ring went round 10 times "
                            f"({laps})")
    checks.append("ring")

    # Send/Recv between every pair, int8
    reqs, dbs = [], {}
    for q in range(n):
        if q != r:
            dbs[q] = recvbuf(mine["i8"])
            reqs.append(W.Irecv(dbs[q], source=q, tag=300 + q))
    for q in range(n):
        if q != r:
            reqs.append(W.Isend(mine["i8"], dest=q, tag=300 + r))
    M.Request.Waitall(reqs)
    for q, db in dbs.items():
        check(db, every[q]["i8"], f"Send/Recv {q}->{r} int8")

    # Bcast from the last rank (not 0), f32
    root = n - 1
    db = DeviceBuffer(mine["f32"]) if r == root else recvbuf(mine["f32"])
    W.Bcast(db, root=root)
    check(db, every[root]["f32"], "Bcast f32 root n-1")

    # Allreduce SUM f32 and MAX bf16, Reduce SUM int8 at root 1
    f32_sum = torch.stack([e["f32"] for e in every]).sum(0)
    db = recvbuf(mine["f32"])
    W.Allreduce(mine["f32"], db, op=op.SUM)
    check(db, f32_sum, "Allreduce SUM f32")
    db = recvbuf(mine["bf16"])
    W.Allreduce(mine["bf16"], db, op=op.MAX)
    check(db, torch.stack([e["bf16"] for e in every]).amax(0),
          "Allreduce MAX bf16")
    i8_sum = torch.stack([e["i8"].to(torch.int64) for e in every]).sum(0) \
        .to(torch.int8)  # the wrapped sum
    db = recvbuf(mine["i8"])
    W.Reduce(mine["i8"], db, op=op.SUM, root=1 % n)
    if r == 1 % n:
        check(db, i8_sum, "Reduce SUM int8 root 1")

    # Allgather int8, Gather bf16 at 0, Scatter f32 from 1
    db = recvbuf(mine["i8"], n * mine["i8"].numel())
    W.Allgather(mine["i8"], db)
    check(db, torch.cat([e["i8"] for e in every]), "Allgather int8")
    db = recvbuf(mine["bf16"], n * mine["bf16"].numel()) if r == 0 \
        else None
    W.Gather(mine["bf16"], db, root=0)
    if r == 0:
        check(db, torch.cat([e["bf16"] for e in every]), "Gather bf16")
    chunk = mine["f32"].numel() // n
    db = recvbuf(mine["f32"], chunk)
    W.Scatter(mine["f32"], db, root=1 % n)
    check(db, every[1 % n]["f32"][r * chunk:(r + 1) * chunk],
          "Scatter f32 root 1")

    # Alltoall f32, Reduce_scatter_block SUM f32
    db = recvbuf(mine["f32"])
    W.Alltoall(mine["f32"], db)
    check(db, torch.cat([e["f32"][r * chunk:(r + 1) * chunk]
                         for e in every]), "Alltoall f32")
    db = recvbuf(mine["f32"], chunk)
    W.Reduce_scatter_block(mine["f32"], db, op=op.SUM)
    check(db, f32_sum[r * chunk:(r + 1) * chunk],
          "Reduce_scatter_block SUM f32")

    # Scan SUM bf16, Exscan SUM int8
    db = recvbuf(mine["bf16"])
    W.Scan(mine["bf16"], db, op=op.SUM)
    acc = every[0]["bf16"]
    for q in range(1, r + 1):
        acc = acc + every[q]["bf16"]  # exact: |sum| <= 32
    check(db, acc, "Scan SUM bf16")
    db = recvbuf(mine["i8"])
    W.Exscan(mine["i8"], db, op=op.SUM)
    if r > 0:
        ex = torch.stack([every[q]["i8"].to(torch.int64)
                          for q in range(r)]).sum(0).to(torch.int8)
        check(db, ex, "Exscan SUM int8")

    # Split(r % 2) and Dup, each with an int8 SUM
    sub = W.Split(color=r % 2, key=r)
    db = recvbuf(mine["i8"])
    sub.Allreduce(mine["i8"], db, op=op.SUM)
    check(db, torch.stack([every[q]["i8"].to(torch.int64)
                           for q in range(r % 2, n, 2)]).sum(0)
          .to(torch.int8), "Split(r % 2) Allreduce SUM int8")
    dup = W.Dup()
    db = recvbuf(mine["i8"])
    dup.Allreduce(mine["i8"], db, op=op.SUM)
    check(db, i8_sum, "Dup Allreduce SUM int8")
    sub.Free()
    dup.Free()

    # check_accelerator.py's counterpart: a tensor on the card sent into a
    # DeviceBuffer, an allreduce of bf16 device buffers, a DeviceBuffer
    # bcast
    if r == 0:
        W.Send(torch.arange(5, dtype=torch.float32, device=device) * 3,
               dest=1, tag=1)
    elif r == 1:
        out = DeviceBuffer((5,), torch.float32)
        W.Recv(out, source=0, tag=1)
        check(out, torch.arange(5, dtype=torch.float32, device=device) * 3,
              "accelerator Send/Recv")
    send = torch.full((4,), float(r + 1), dtype=torch.bfloat16,
                      device=device)
    out = DeviceBuffer((4,), torch.bfloat16)
    W.Allreduce(send, out)
    check(out, torch.full((4,), n * (n + 1) / 2, dtype=torch.bfloat16,
                          device=device), "accelerator Allreduce bf16")
    db = DeviceBuffer(torch.arange(3, dtype=torch.int32, device=device)
                      + 10) if r == 0 else DeviceBuffer((3,), torch.int32)
    W.Bcast(db, root=0)
    check(db, torch.arange(3, dtype=torch.int32, device=device) + 10,
          "accelerator Bcast")

    # bf16 through stage_to_host and back
    host = stage_to_host(mine["bf16"])
    back = torch.from_numpy(host.copy()).view(torch.bfloat16).to(device)
    check(back, mine["bf16"], "bf16 stage_to_host round trip")

    # a raw tensor on the card is no receive buffer
    if device == "cuda":
        raised = False
        req = None
        try:
            req = W.Irecv(torch.zeros(2, device=device), source=r, tag=7)
            W.Send(np.ones(2, np.float32), dest=r, tag=7)
            req.Wait()
        except (M.MPIError, ValueError):
            raised = True
        require(raised, "procmode: a receive into a raw CUDA tensor fails "
                        "loudly")
        checks.append("raw CUDA receive refused")

    timings = {}
    W.Barrier()
    if n >= 2 and r in (0, 1):
        peer = 1 - r
        # latency: an 8-byte ping-pong of host buffers
        a = np.zeros(1, np.int64)
        t = []
        for i in range(PM_LAT_ITERS + 10):
            t0 = time.perf_counter()
            if r == 0:
                W.Send(a, dest=peer, tag=50)
                W.Recv(a, source=peer, tag=51)
            else:
                W.Recv(a, source=peer, tag=50)
                W.Send(a, dest=peer, tag=51)
            t.append(time.perf_counter() - t0)
        timings["latency_us_8B"] = round(
            float(np.median(t[10:])) / 2 * 1e6, 2)
        # bandwidth: ping-pongs staged from the card, uploaded on arrival
        bw = {}
        for nbytes in PM_PINGPONG:
            nbytes //= scale
            x = mine["i8"].new_zeros(nbytes) + r
            db = DeviceBuffer((nbytes,), torch.int8)
            rounds = 3 if nbytes >= (16 << 20) else 20
            best = None
            for _ in range(rounds + 1):
                _pm_sync(device)
                t0 = time.perf_counter()
                if r == 0:
                    W.Send(x, dest=peer, tag=60)
                    W.Recv(db, source=peer, tag=61)
                    db.array
                else:
                    W.Recv(db, source=peer, tag=60)
                    W.Send(db.array, dest=peer, tag=61)
                _pm_sync(device)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            bw[str(nbytes)] = round(2 * nbytes / best / 1e9, 4)
        timings["pingpong_gbs"] = bw
    W.Barrier()
    # host ms of a 64 MB Allreduce, the send staged, the result uploaded
    db = recvbuf(mine["f32"])
    ms = []
    for _ in range(3):
        W.Barrier()
        _pm_sync(device)
        t0 = time.perf_counter()
        W.Allreduce(mine["f32"], db, op=op.SUM)
        db.array
        _pm_sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    check(db, f32_sum, "timed Allreduce SUM f32")
    timings["allreduce_64mb_host_ms"] = [round(min(ms), 2),
                                         round(max(ms), 2)]
    # D2H and H2D of the 64 MB f32 payload
    _pm_sync(device)
    t0 = time.perf_counter()
    host = stage_to_host(mine["f32"])
    d2h = host.nbytes / (time.perf_counter() - t0) / 1e9
    db = DeviceBuffer(torch.from_numpy(host.copy()))
    t0 = time.perf_counter()
    up = db.array
    _pm_sync(device)
    h2d = host.nbytes / (time.perf_counter() - t0) / 1e9
    check(up, mine["f32"], "H2D upload")
    timings["d2h_gbs"], timings["h2d_gbs"] = round(d2h, 3), round(h2d, 3)
    W.Barrier()
    btls = sorted({type(b).__name__ for p, b in W.pml.endpoints.items()
                   if p != W.pml.my_rank})
    print("PROCMODE-RANK " + json.dumps({
        "rank": r, "size": n, "checks": len(checks), "btls": btls,
        "device": str(mine["f32"].device), "started_s": round(started, 2),
        "seconds": round(time.perf_counter() - t_start, 2),
        **({"timings": timings} if r == 0 else {})}), flush=True)
    M.Finalize()
    return 0


def phase_procmode(card, device="cuda", scale=1, rank_prog=None):
    """Phase 4m: the port's process mode on the card. ``mpirun`` of the
    port launches ``chip_smoke.py --child procmode_rank`` (or
    ``rank_prog``) as 4 ranks over ``self,sm``, 4 over ``self,tcp`` and 3
    over the default btls, all sharing the card; a rank that fails fails
    the phase. Prints one ``{"procmode": ...}`` line."""
    t0 = time.perf_counter()
    prog = rank_prog or [os.path.abspath(__file__), "--child",
                         "procmode_rank"]
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    if device == "cpu":  # a rehearsal keeps DeviceBuffers on the host
        env["OMPI_TPU_MCA_accelerator_accelerator"] = "null"
    jobs = []
    for n, mca, btl in PM_JOBS:
        cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun", "-np",
               str(n), "--timeout", str(PM_JOB_TIMEOUT_S)]
        for k, v in mca:
            cmd += ["--mca", k, v]
        tj = time.perf_counter()
        env["CHIP_SMOKE_PM_T0"] = repr(time.time())
        p = subprocess.run(cmd + prog, capture_output=True, text=True,
                           timeout=PM_JOB_TIMEOUT_S + 30, env=env,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        label = ",".join(f"{k}={v}" for k, v in mca) or "default btls"
        # ranks share the pipe, so a line may hold two ranks' prints
        dec, tag = json.JSONDecoder(), "PROCMODE-RANK "
        ranks = [dec.raw_decode(p.stdout, m.end())[0]
                 for m in re.finditer(tag, p.stdout)]
        if p.returncode != 0 or len(ranks) != n:
            print(p.stdout[-4000:], p.stderr[-8000:], file=sys.stderr)
        require(p.returncode == 0, f"procmode: the {n}-rank job over {label} "
                                   f"exits 0 (rc {p.returncode})")
        require(sorted(x["rank"] for x in ranks) == list(range(n)),
                f"procmode: every rank of the {n}-rank job over {label} "
                "reports")
        require(all(x["device"].startswith(device) for x in ranks),
                f"procmode: every rank of the job over {label} ran on "
                f"{device}")
        require(all(x["btls"] == [btl] for x in ranks),
                f"procmode: the job over {label} reaches its peers by "
                f"{btl} ({ranks[0]['btls']})")
        timings = next(x["timings"] for x in ranks if x["rank"] == 0)
        jobs.append({"ranks": n, "mca": label, "btls": ranks[0]["btls"],
                     "checks": sum(x["checks"] for x in ranks),
                     "wall_s": round(time.perf_counter() - tj, 1),
                     "start_s": max(x["started_s"] for x in ranks),
                     "rank_s": max(x["seconds"] for x in ranks),
                     **timings})
    secs = time.perf_counter() - t0
    print(json.dumps({"procmode": {"card": card, "scale": scale,
                                   "jobs": jobs,
                                   "phase_s": round(secs, 1)}}), flush=True)
    print(f"phase 4m: {len(jobs)} jobs, "
          f"{sum(j['checks'] for j in jobs)} bit-exact checks on the card; "
          f"{secs:.1f} s on {card}", flush=True)
    return jobs


# ------------------------------------------------ phase 4n: the coll stack
# the jobs of the default host collective stack on the card: (ranks, --mca
# pairs, rank mode, btl). The sm job exists to time tuned against basic
# (P.1), and its ranks share one sm node, where coll/sm (priority 50) would
# take the Allreduce: it excludes sm alone; it also arms the failure
# detector for its Shrink. The sessions job runs over the default btls, so
# its ranks share an sm node card too: it excludes sm for the same reason.
# The tcp job runs at the default selection: no rank has an sm node card,
# so sm, han and hier decline
CS_PIN = (("coll_coll", "^sm"),)
CS_FT = (("ft_enable", "1"), ("ft_heartbeat_period", "0.25"),
         ("ft_heartbeat_timeout", "4.0"))
CS_JOBS = ((4, (("btl_btl", "self,sm"),) + CS_PIN + CS_FT, "world",
            "SmBtl"),
           (4, (("btl_btl", "self,tcp"), ("btl_tcp_reliable", "0")),
            "world", "TcpBtl"),
           (3, CS_PIN, "sessions", None))
CS_SEED = 1515
CS_BYTES = 64 << 20       # the 64 MB calls: per-call payload a rank
CS_SMALL_BYTES = 4 << 10  # the 4 KB Allreduce: recursive doubling
CS_STARTS = 3
CS_SLEEP_MS = 50
CS_JOB_TIMEOUT_S = 150
# the round-schedule algorithms tuned and nbc hand to the round engine
CS_ALGOS = ("allreduce_recursive_doubling", "allreduce_ring",
            "allgather_ring", "allgather_bruck", "alltoall_pairwise",
            "reduce_binomial", "reduce_linear", "bcast_binomial",
            "barrier_dissemination", "gather_linear", "scatter_linear",
            "scan_linear", "exscan_linear", "reduce_scatter_block_sched")


def cs_payloads(rank, n, device, scale=1):
    """Rank ``rank``'s payloads in a job of ``n`` ranks, made on ``device``
    from a seeded generator: integer-valued f32 and bf16 of 64 MB (every
    sum below is exact) and a 4 KB f32; counts divide by ``n``."""
    gen = torch.Generator(device=device).manual_seed(CS_SEED + rank)

    def count(nbytes, size):
        return max(n, nbytes // scale // size // n * n)

    return {
        "f32": torch.randint(-1000, 1000, (count(CS_BYTES, 4),),
                             generator=gen, device=device).to(torch.float32),
        "bf16": torch.randint(-8, 8, (count(CS_BYTES, 2),), generator=gen,
                              device=device).to(torch.bfloat16),
        "small": torch.randint(-1000, 1000, (CS_SMALL_BYTES // 4,),
                               generator=gen, device=device)
        .to(torch.float32)}


def coll_rank(device="cuda", scale=1) -> int:
    """One rank of phase 4n (``chip_smoke.py --child coll_rank MODE``
    under the port's ``mpirun``). Prints one ``COLL-RANK {json}`` line
    (before the Shrink, which the last rank does not survive) and, on a
    survivor, one ``COLL-SHRINK {json}`` line."""
    import ompi_tpu_torch as M
    from ompi_tpu_torch.accelerator import DeviceBuffer
    from ompi_tpu_torch.coll import algorithms as alg
    from ompi_tpu_torch.core import op
    from ompi_tpu_torch.mca.var import all_pvars, get_var, set_var

    t_start = time.perf_counter()
    mode = sys.argv[-1] if sys.argv[-1] in ("world", "sessions") \
        else "world"
    chosen = []  # the algorithms handed to the round engine, in order

    def record(name, fn):
        def wrapped(*a, **kw):
            nseg = kw.get("nseg", 1)
            chosen.append(name if nseg == 1 else f"{name}[nseg={nseg}]")
            return fn(*a, **kw)
        return wrapped

    for name in CS_ALGOS:
        setattr(alg, name, record(name, getattr(alg, name)))
    session = None
    if mode == "sessions":
        from ompi_tpu_torch.runtime.session import Session

        session = Session.Init()
        W = session.Comm_create_from_group(
            session.Group_from_pset("mpi://WORLD"), tag="chip-smoke-4n")
    else:
        W = M.COMM_WORLD
    r, n = W.Get_rank(), W.Get_size()
    mine = cs_payloads(r, n, device, scale)
    every = [mine if q == r else cs_payloads(q, n, device, scale)
             for q in range(n)]
    checks, algos = [], {}

    def check(got_db, want, what):
        got = got_db.array if isinstance(got_db, DeviceBuffer) else got_db
        require(got.device.type == torch.device(device).type,
                f"coll rank {r}: {what} lands on {device}")
        ok = got.dtype == want.dtype and got.shape == want.shape \
            and torch.equal(_bits(got), _bits(want))
        require(ok, f"coll rank {r}: {what} bit-exact on {device}")
        checks.append(what)

    def db_like(t, numel=None):
        return DeviceBuffer((t.numel() if numel is None else numel,),
                            t.dtype)

    def blocking(verb, what, call):
        """Run ``call`` and note which component and algorithm took it."""
        del chosen[:]
        call()
        algos[what] = {"provider": W.coll.providers[verb],
                       "algorithm": chosen[0] if chosen else
                       W.coll.providers[verb]}

    def total(key, q=None):
        ts = [e[key] for e in every] if q is None else [every[i][key]
                                                        for i in q]
        return torch.stack([t.to(torch.float32) for t in ts]).sum(0) \
            .to(ts[0].dtype)

    f32, bf16, small = mine["f32"], mine["bf16"], mine["small"]
    chunk = f32.numel() // n
    # ---- tuned: the blocking verbs at 4 KB and 64 MB
    db = db_like(small)
    blocking("allreduce", "Allreduce SUM f32 4 KB",
             lambda: W.Allreduce(small, db, op=op.SUM))
    check(db, total("small"), "Allreduce SUM f32 4 KB")
    for key in ("f32", "bf16"):
        db = db_like(mine[key])
        blocking("allreduce", f"Allreduce SUM {key} 64 MB",
                 lambda: W.Allreduce(mine[key], db, op=op.SUM))
        check(db, total(key), f"Allreduce SUM {key} 64 MB")
    root = n - 1
    db = DeviceBuffer(bf16) if r == root else db_like(bf16)
    blocking("bcast", "Bcast bf16 64 MB", lambda: W.Bcast(db, root=root))
    check(db, every[root]["bf16"], "Bcast bf16 64 MB")
    db = db_like(f32)
    blocking("allgather", "Allgather f32 64 MB",
             lambda: W.Allgather(f32[r * chunk:(r + 1) * chunk], db))
    check(db, torch.cat([every[q]["f32"][q * chunk:(q + 1) * chunk]
                         for q in range(n)]), "Allgather f32 64 MB")
    db = db_like(f32)
    blocking("alltoall", "Alltoall f32 64 MB", lambda: W.Alltoall(f32, db))
    check(db, torch.cat([e["f32"][r * chunk:(r + 1) * chunk]
                         for e in every]), "Alltoall f32 64 MB")
    db = db_like(f32, chunk)
    blocking("reduce_scatter_block", "Reduce_scatter_block SUM f32 64 MB",
             lambda: W.Reduce_scatter_block(f32, db, op=op.SUM))
    check(db, total("f32")[r * chunk:(r + 1) * chunk],
          "Reduce_scatter_block SUM f32 64 MB")

    # ---- nbc: every i-verb at 64 MB issued before queued card work,
    # waited after it
    sleep = _sleep_cycles(CS_SLEEP_MS) if device == "cuda" else 0
    half = bf16.numel() // n
    displs = [q * chunk for q in range(n)]
    out = {"ibcast": DeviceBuffer(f32) if r == 1 % n else db_like(f32),
           "ireduce": db_like(f32), "iallreduce": db_like(f32),
           "iallreduce_bf16": db_like(bf16), "iallgather": db_like(f32),
           "iallgatherv": db_like(f32), "ialltoall": db_like(bf16),
           "ialltoallv": db_like(f32), "igather": db_like(bf16),
           "igatherv": db_like(bf16), "iscatter": db_like(bf16, half),
           "iscatterv": db_like(bf16, half),
           "ireduce_scatter_block": db_like(f32, chunk),
           "iscan": db_like(bf16), "iexscan": db_like(f32)}
    _pm_sync(device)
    reqs = [W.Ibarrier(),
            W.Ibcast(out["ibcast"], root=1 % n),
            W.Ireduce(f32, out["ireduce"], op=op.SUM, root=0),
            W.Iallreduce(f32, out["iallreduce"], op=op.SUM),
            W.Iallreduce(bf16, out["iallreduce_bf16"], op=op.SUM),
            W.Iallgather(f32[r * chunk:(r + 1) * chunk], out["iallgather"]),
            W.Iallgatherv(f32[r * chunk:(r + 1) * chunk],
                          out["iallgatherv"], [chunk] * n),
            W.Ialltoall(bf16, out["ialltoall"]),
            W.Ialltoallv(f32, out["ialltoallv"], [chunk] * n, displs,
                         [chunk] * n, displs),
            W.Igatherv(bf16[r * half:(r + 1) * half], out["igatherv"],
                       [half] * n, root=0),
            W.Iscatterv(bf16, out["iscatterv"], [half] * n, root=0),
            W.Igather(bf16[r * half:(r + 1) * half], out["igather"],
                      root=0),
            W.Iscatter(bf16, out["iscatter"], root=0),
            W.Ireduce_scatter_block(f32, out["ireduce_scatter_block"],
                                    op=op.SUM),
            W.Iscan(bf16, out["iscan"], op=op.SUM),
            W.Iexscan(f32, out["iexscan"], op=op.SUM)]
    issued = sum(1 for q in reqs if not q.is_complete)
    if device == "cuda":
        torch.cuda._sleep(sleep)  # queued behind the issue, on the card
    M.Request.Waitall(reqs)
    _pm_sync(device)
    check(out["ibcast"], every[1 % n]["f32"], "Ibcast f32")
    if r == 0:
        check(out["ireduce"], total("f32"), "Ireduce SUM f32")
        for name in ("igather", "igatherv"):
            check(out[name], torch.cat(
                [every[q]["bf16"][q * half:(q + 1) * half]
                 for q in range(n)]), f"{name[0].upper()}{name[1:]} bf16")
    check(out["iallreduce"], total("f32"), "Iallreduce SUM f32")
    check(out["iallreduce_bf16"], total("bf16"), "Iallreduce SUM bf16")
    check(out["iallgather"], torch.cat(
        [every[q]["f32"][q * chunk:(q + 1) * chunk] for q in range(n)]),
        "Iallgather f32")
    check(out["ialltoall"], torch.cat(
        [e["bf16"][r * half:(r + 1) * half] for e in every]),
        "Ialltoall bf16")
    check(out["iallgatherv"], torch.cat(
        [every[q]["f32"][q * chunk:(q + 1) * chunk] for q in range(n)]),
        "Iallgatherv f32")
    check(out["ialltoallv"], torch.cat(
        [e["f32"][r * chunk:(r + 1) * chunk] for e in every]),
        "Ialltoallv f32")
    for name in ("iscatter", "iscatterv"):
        check(out[name], every[0]["bf16"][r * half:(r + 1) * half],
              f"{name[0].upper()}{name[1:]} bf16")
    check(out["ireduce_scatter_block"],
          total("f32")[r * chunk:(r + 1) * chunk],
          "Ireduce_scatter_block SUM f32")
    check(out["iscan"], total("bf16", range(r + 1)), "Iscan SUM bf16")
    if r > 0:
        check(out["iexscan"], total("f32", range(r)), "Iexscan SUM f32")

    # ---- persistent: Allreduce_init, three Starts, frozen and re-issued;
    # the operands are host tensors staged from the card before each
    # Start (a CUDA tensor re-stages per call, so it always re-issues)
    results, plans = {}, {}
    hsend = torch.empty(f32.numel(), dtype=torch.float32)
    hrecv = torch.empty(f32.numel(), dtype=torch.float32)
    prev = get_var("coll_persist", "enable")
    for enable in (1, 0):
        set_var("coll_persist", "enable", enable)
        p0 = all_pvars()["persist_plans"].value
        req = W.Allreduce_init(hsend, hrecv, op=op.SUM)
        got = []
        for k in range(CS_STARTS):
            hsend.copy_(f32 * (k + 1))
            req.Start()
            req.Wait()
            got.append(hrecv.to(device))
            check(got[-1], total("f32") * (k + 1),
                  f"Allreduce_init Start {k} persist_enable={enable}")
        req.Free()
        plans[enable] = all_pvars()["persist_plans"].value - p0
        results[enable] = got
    set_var("coll_persist", "enable", prev)
    require(plans == {1: 1, 0: 0}, f"coll rank {r}: one frozen plan under "
                                   f"coll_persist_enable=1 ({plans})")
    for a, b in zip(results[1], results[0]):
        check(a, b, "frozen replay equals re-issue")

    # ---- neighbor: a ring dist-graph
    ring = [(r - 1) % n, (r + 1) % n]
    dg = W.Create_dist_graph_adjacent(ring, ring)
    db = db_like(bf16, 2 * bf16.numel())
    dg.Neighbor_allgather(bf16, db)
    check(db, torch.cat([every[q]["bf16"] for q in ring]),
          "Neighbor_allgather bf16 ring")
    half_f = f32.numel() // 2
    db = db_like(f32, 2 * half_f)
    dg.Neighbor_alltoall(f32[:2 * half_f], db)
    # block j of mine goes to out-neighbour j; block j of mine comes from
    # in-neighbour j, which sent me its block naming me: the left neighbour
    # (r-1) names me second, the right one (r+1) first
    check(db, torch.cat([every[ring[0]]["f32"][half_f:2 * half_f],
                         every[ring[1]]["f32"][:half_f]]),
          "Neighbor_alltoall f32 ring")
    dg.Free()

    timings = {}
    if mode == "world":
        # host ms of a 64 MB Allreduce through tuned, and through basic on
        # a Dup that selects coll/basic alone, on the same job
        pin = get_var("coll", "coll")
        set_var("coll", "coll", "self,basic")
        bw = W.Dup()
        set_var("coll", "coll", pin)
        require(bw.coll.providers["allreduce"] == "basic",
                "coll: the Dup selects basic")
        for label, comm in (("tuned", W), ("basic", bw)):
            db = db_like(f32)
            ms = []
            for _ in range(3):
                comm.Barrier()
                _pm_sync(device)
                t0 = time.perf_counter()
                comm.Allreduce(f32, db, op=op.SUM)
                db.array
                _pm_sync(device)
                ms.append((time.perf_counter() - t0) * 1e3)
            check(db, total("f32"), f"timed Allreduce SUM f32 ({label})")
            timings[f"allreduce_64mb_host_ms_{label}"] = [
                round(min(ms), 2), round(max(ms), 2)]
        bw.Free()
    W.Barrier()
    line = {"rank": r, "size": n, "mode": mode, "checks": len(checks),
            "algorithms": algos, "iverbs": len(reqs),
            "issued_pending": issued,
            "device": str(f32.device),
            "btls": sorted({type(b).__name__
                            for p, b in W.pml.endpoints.items()
                            if p != W.pml.my_rank}),
            "seconds": round(time.perf_counter() - t_start, 2),
            **({"timings": timings} if r == 0 else {})}
    print("COLL-RANK " + json.dumps(line), flush=True)
    if mode == "sessions":
        W.Free()
        session.Finalize()
        return 0
    if get_var("ft", "enable"):  # the sm job's Shrink
        _coll_shrink(M, W, r, n, mine, every, device, check)
    M.Finalize()
    return 0


def _coll_shrink(M, W, r, n, mine, every, device, check):
    """The sm job's Shrink: ``ft.inject`` kills the last rank after a few
    more pml operations; the survivors see the failure, revoke, wait for
    the detector, ``Shrink`` and Allreduce from the card on the shrunk
    comm. Prints ``COLL-SHRINK {json}`` on each survivor."""
    from ompi_tpu_torch.accelerator import DeviceBuffer
    from ompi_tpu_torch.core import op
    from ompi_tpu_torch.core.errors import MPIError
    from ompi_tpu_torch.ft import inject
    from ompi_tpu_torch.ft.detector import known_failed
    from ompi_tpu_torch.runtime.progress import progress_until

    t0 = time.perf_counter()
    W.Barrier()
    inject.install(f"kill({n - 1},after=12)")
    x = np.full(4, float(r + 1))
    out = np.zeros(4)
    code = None
    for _ in range(1000):
        try:
            W.Allreduce(x, out)
        except MPIError as e:
            code = e.code
            W.Revoke()
            break
    require(code is not None, f"coll rank {r}: the injected kill surfaced")
    deadline = time.monotonic() + 30
    progress_until(lambda: (n - 1) in known_failed()
                   or time.monotonic() > deadline)
    require((n - 1) in known_failed(),
            f"coll rank {r}: the detector declared rank {n - 1} failed")
    s = W.Shrink()
    require(s.Get_size() == n - 1 and s.Get_rank() == r,
            f"coll rank {r}: the shrunk comm has the survivors")
    db = DeviceBuffer((mine["f32"].numel(),), torch.float32)
    s.Allreduce(mine["f32"], db, op=op.SUM)
    want = torch.stack([every[q]["f32"] for q in range(n - 1)]).sum(0)
    check(db, want, "Shrink Allreduce SUM f32 64 MB")
    s.Barrier()
    print("COLL-SHRINK " + json.dumps({
        "rank": r, "size": s.Get_size(), "code": code,
        "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    inject.uninstall()


def phase_collstack(card, device="cuda", scale=1, rank_prog=None):
    """Phase 4n: the default host collective stack on the card. The port's
    ``mpirun`` launches ``chip_smoke.py --child coll_rank MODE`` (or
    ``rank_prog``) as 4 ranks over ``self,sm`` (with the Shrink), 4 over
    ``self,tcp`` and a 3-rank sessions-only job, all sharing the card; a
    rank that fails fails the phase. Prints the 64 MB Allreduce's host ms
    through tuned and through basic and the phase's seconds, each with the
    card, and one ``{"collstack": ...}`` line."""
    t0 = time.perf_counter()
    prog = rank_prog or [os.path.abspath(__file__), "--child", "coll_rank"]
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    if device == "cpu":  # a rehearsal keeps DeviceBuffers on the host
        env["OMPI_TPU_MCA_accelerator_accelerator"] = "null"
    jobs = []
    for n, mca, mode, btl in CS_JOBS:
        cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun", "-np",
               str(n), "--timeout", str(CS_JOB_TIMEOUT_S)]
        for k, v in mca:
            cmd += ["--mca", k, v]
        shrink = any(k == "ft_enable" for k, _ in mca)
        tj = time.perf_counter()
        p = subprocess.run(cmd + prog + [mode], capture_output=True,
                           text=True, timeout=CS_JOB_TIMEOUT_S + 30, env=env,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        label = ",".join(f"{k}={v}" for k, v in mca)
        dec = json.JSONDecoder()
        ranks = [dec.raw_decode(p.stdout, m.end())[0]
                 for m in re.finditer("COLL-RANK ", p.stdout)]
        shrunk = [dec.raw_decode(p.stdout, m.end())[0]
                  for m in re.finditer("COLL-SHRINK ", p.stdout)]
        if p.returncode != 0 or len(ranks) != n:
            print(p.stdout[-4000:], p.stderr[-8000:], file=sys.stderr)
        require(p.returncode == 0, f"collstack: the {n}-rank {mode} job "
                                   f"over {label} exits 0 "
                                   f"(rc {p.returncode})")
        require(sorted(x["rank"] for x in ranks) == list(range(n)),
                f"collstack: every rank of the {n}-rank job over {label} "
                "reports")
        require(all(x["device"].startswith(device) for x in ranks),
                f"collstack: every rank of the job over {label} ran on "
                f"{device}")
        if btl is not None:
            require(all(x["btls"] == [btl] for x in ranks),
                    f"collstack: the job over {label} reaches its peers by "
                    f"{btl} ({ranks[0]['btls']})")
        if shrink:
            require(sorted(x["rank"] for x in shrunk) == list(range(n - 1))
                    and all(x["size"] == n - 1 for x in shrunk),
                    f"collstack: the {n - 1} survivors of the job over "
                    f"{label} Shrink and Allreduce")
        r0 = next(x for x in ranks if x["rank"] == 0)
        for what, a in sorted(r0["algorithms"].items()):
            print(f"phase 4n: {n} ranks, {mode}, {btl or 'default btls'}: "
                  f"{what} -> {a['provider']}/{a['algorithm']}", flush=True)
        jobs.append({"ranks": n, "mode": mode, "mca": label,
                     "btls": r0["btls"],
                     "checks": sum(x["checks"] for x in ranks),
                     "algorithms": r0["algorithms"],
                     "iverbs": r0["iverbs"],
                     "pending_at_issue": min(x["issued_pending"]
                                             for x in ranks),
                     "shrink_s": max((x["seconds"] for x in shrunk),
                                     default=None),
                     "wall_s": round(time.perf_counter() - tj, 1),
                     "rank_s": max(x["seconds"] for x in ranks),
                     **r0.get("timings", {})})
    secs = time.perf_counter() - t0
    for j in jobs:
        if "allreduce_64mb_host_ms_tuned" in j:
            print(f"phase 4n: 64 MB Allreduce host ms [min, max of 3], "
                  f"{j['ranks']} ranks over {j['btls'][0]}: tuned "
                  f"{j['allreduce_64mb_host_ms_tuned']}, basic "
                  f"{j['allreduce_64mb_host_ms_basic']} on {card}",
                  flush=True)
    print(json.dumps({"collstack": {"card": card, "scale": scale,
                                    "jobs": jobs,
                                    "phase_s": round(secs, 1)}}), flush=True)
    print(f"phase 4n: {len(jobs)} jobs, "
          f"{sum(j['checks'] for j in jobs)} bit-exact checks on the card; "
          f"{secs:.1f} s on {card}", flush=True)
    return jobs


# ------------------------------------------- phase 4o: the host collectives
# the jobs of the rest of the host collectives on the card: (name, ranks,
# --mca pairs). The collectives job runs 4 ranks over self,sm at the
# default selection, then the same verbs on a Dup under each of HC_SETS
# (han, hier, sm and adapt read their variables when a comm is built, so
# one job serves the three; a job start costs about 20 s on the GPU host).
# The quant jobs run over the plain tcp stream (as 4m's and 4n's tcp jobs
# do), once with int8 codes, once with fp8, and once with quant_enable on
# every rank but rank 1 (set by the rank program before Init), where
# every rank falls back together
HC_SM = (("btl_btl", "self,sm"),)
HC_TCP = (("btl_btl", "self,tcp"), ("btl_tcp_reliable", "0"))
HC_QUANT = (("quant_enable", "1"), ("quant_min_bytes", "2048"))
HC_JOBS = (("collectives", 4, HC_SM),
           ("quant_int8", 3, HC_TCP + HC_QUANT),
           ("quant_fp8", 3, HC_TCP + HC_QUANT + (("quant_mode", "fp8"),)),
           ("quant_fallback", 3, HC_TCP))
# the comms of the collectives job: the world, and a Dup under each setting
HC_SETS = (("sm", ()),
           ("hier", (("coll_hier", "fake_nodes", 2),)),
           ("han", (("coll_han", "fake_nodes", 2),
                    ("coll_hier", "enable", False),
                    ("coll_adapt", "enable", True))))
HC_SEED = 1616
HC_BYTES = 64 << 20       # the 64 MB calls: per-call payload a rank
HC_SMALL_BYTES = 4 << 10  # the 4 KB calls
HC_TIMED = 3              # 64 MB Allreduces timed through sm and tuned
HC_JOB_TIMEOUT_S = 150
# the slots each comm's component must serve (sm on an x86_64 host only)
HC_SERVES = {"sm": {"sm": ("barrier", "bcast", "allreduce", "reduce",
                           "allgather", "gather", "scatter", "alltoall")},
             "hier": {"hier": ("allreduce", "bcast", "allgather",
                               "reduce_scatter_block")},
             "han": {"han": ("allreduce", "barrier"),
                     "adapt": ("bcast", "reduce")},
             "quant_int8": {"quant": ("allreduce", "allgather",
                                      "reduce_scatter_block")},
             "quant_fp8": {"quant": ("allreduce", "allgather",
                                     "reduce_scatter_block")},
             "quant_fallback": {}}


def hc_payloads(rank, n, device, scale=1):
    """Rank ``rank``'s payloads in a job of ``n`` ranks, made on ``device``
    from a seeded generator: integer-valued f32 and bf16 of 64 MB and 4 KB
    (every sum and max below is exact); counts divide by ``n``."""
    gen = torch.Generator(device=device).manual_seed(HC_SEED + rank)

    def count(nbytes, size):
        return max(n, nbytes // size // n * n)

    out = {}
    for tag, nbytes in (("64 MB", HC_BYTES // scale),
                        ("4 KB", HC_SMALL_BYTES)):
        out[f"f32 {tag}"] = torch.randint(
            -1000, 1000, (count(nbytes, 4),), generator=gen,
            device=device).to(torch.float32)
        out[f"bf16 {tag}"] = torch.randint(
            -8, 8, (count(nbytes, 2),), generator=gen,
            device=device).to(torch.bfloat16)
    return out


class _HcRank:
    """What one rank of phase 4o checks and records, comm by comm."""

    def __init__(self, r, n, device, scale):
        self.r, self.n, self.device = r, n, device
        self.mine = hc_payloads(r, n, device, scale)
        self.every = [self.mine if q == r else hc_payloads(q, n, device,
                                                           scale)
                      for q in range(n)]
        self.checks = []
        self.flat_calls = []

    def check(self, got_db, want, what):
        from ompi_tpu_torch.accelerator import DeviceBuffer

        got = got_db.array if isinstance(got_db, DeviceBuffer) else got_db
        require(got.device.type == torch.device(self.device).type,
                f"hostcoll rank {self.r}: {what} lands on {self.device}")
        require(got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(_bits(got), _bits(want)),
                f"hostcoll rank {self.r}: {what} bit-exact on "
                f"{self.device}")
        self.checks.append(what)

    def bounded(self, got, exact, bound, what):
        """A quantized result within the codec's bound of the exact sum,
        compared on the card."""
        err = (got.to(torch.float64) - exact.to(torch.float64)).abs()
        require(got.device.type == torch.device(self.device).type
                and bool((err <= bound.to(got.device)).all()),
                f"hostcoll rank {self.r}: {what} within the codec's bound "
                f"on {self.device}")
        self.checks.append(what + " within the bound")

    def total(self, key, how="sum", q=None):
        ts = [self.every[i][key] for i in (range(self.n) if q is None
                                            else q)]
        s = torch.stack([t.to(torch.float32) for t in ts])
        return (s.sum(0) if how == "sum" else s.amax(0)).to(ts[0].dtype)

    def block(self, q, key, part):
        t = self.every[q][key]
        per = t.numel() // self.n
        return t[part * per:(part + 1) * per]

    def call(self, C, served, verb, what, fn):
        """Run ``fn`` on comm ``C`` and note the component that served it:
        the slot's winner, or where a conditional winner sent it (quant's
        delegation shows as no quantized collective counted; sm's whole
        delegation of an indivisible Alltoall as a call of its flat
        module)."""
        from ompi_tpu_torch.mca.var import all_pvars

        q0 = all_pvars()["quant_colls"].value
        flat0 = len(self.flat_calls)
        fn()
        who = C.coll.providers[verb]
        if who == "quant" and all_pvars()["quant_colls"].value == q0:
            who = "quant->" + C.coll.fallback_providers[verb][0]
        if len(self.flat_calls) > flat0:
            who += "->basic"
        served[what] = who


def _hc_verbs(R, C, name, served, timings):
    """The collectives job's verbs on comm ``C`` (the world at the default
    selection, or a Dup under one of ``HC_SETS``)."""
    from ompi_tpu_torch.accelerator import DeviceBuffer
    from ompi_tpu_torch.coll import smcoll
    from ompi_tpu_torch.core import op
    from ompi_tpu_torch.mca.var import get_var, set_var

    r, n, mine = R.r, R.n, R.mine

    def db_like(t, numel=None):
        return DeviceBuffer((t.numel() if numel is None else numel,),
                            t.dtype)

    sm_mod = getattr(C.coll.slots.get("alltoall"), "__self__", None)
    if isinstance(sm_mod, smcoll.SmColl):
        flat_a2a = sm_mod._flat.alltoall

        def counted_a2a(*a, **kw):
            R.flat_calls.append(1)
            return flat_a2a(*a, **kw)

        sm_mod._flat.alltoall = counted_a2a
    for size in ("4 KB", "64 MB"):
        for key in (f"f32 {size}", f"bf16 {size}"):
            for opname, o in (("SUM", op.SUM), ("MAX", op.MAX)):
                db = db_like(mine[key])
                what = f"Allreduce {opname} {key}"
                R.call(C, served, "allreduce", what,
                       lambda: C.Allreduce(mine[key], db, op=o))
                R.check(db, R.total(key, opname.lower()), what)
    f32, bf16 = mine["f32 64 MB"], mine["bf16 64 MB"]
    root = n - 1
    db = DeviceBuffer(bf16) if r == root else db_like(bf16)
    R.call(C, served, "bcast", "Bcast bf16 64 MB",
           lambda: C.Bcast(db, root=root))
    R.check(db, R.every[root]["bf16 64 MB"], "Bcast bf16 64 MB")
    if name != "hier":
        R.call(C, served, "barrier", "Barrier", C.Barrier)
        db = db_like(f32)
        R.call(C, served, "reduce", "Reduce SUM f32 64 MB",
               lambda: C.Reduce(f32, db, op=op.SUM, root=0))
        if r == 0:
            R.check(db, R.total("f32 64 MB"), "Reduce SUM f32 64 MB")
    if name != "han":
        db = db_like(f32)
        R.call(C, served, "allgather", "Allgather f32 64 MB",
               lambda: C.Allgather(R.block(r, "f32 64 MB", r), db))
        R.check(db, torch.cat([R.block(q, "f32 64 MB", q)
                               for q in range(n)]), "Allgather f32 64 MB")
    if name == "hier":
        db = db_like(f32, f32.numel() // n)
        R.call(C, served, "reduce_scatter_block",
               "Reduce_scatter_block SUM f32 64 MB",
               lambda: C.Reduce_scatter_block(f32, db, op=op.SUM))
        R.check(db, R.total("f32 64 MB")[r * db.host.numel():
                                         (r + 1) * db.host.numel()],
                "Reduce_scatter_block SUM f32 64 MB")
    if name != "sm":
        return
    db = db_like(bf16)
    R.call(C, served, "gather", "Gather bf16 64 MB",
           lambda: C.Gather(R.block(r, "bf16 64 MB", r), db, root=0))
    if r == 0:
        R.check(db, torch.cat([R.block(q, "bf16 64 MB", q)
                               for q in range(n)]), "Gather bf16 64 MB")
    db = db_like(bf16, bf16.numel() // n)
    R.call(C, served, "scatter", "Scatter bf16 64 MB",
           lambda: C.Scatter(bf16, db, root=0))
    R.check(db, R.block(0, "bf16 64 MB", r), "Scatter bf16 64 MB")
    db = db_like(f32)
    R.call(C, served, "alltoall", "Alltoall f32 64 MB",
           lambda: C.Alltoall(f32, db))
    R.check(db, torch.cat([R.block(q, "f32 64 MB", r) for q in range(n)]),
            "Alltoall f32 64 MB")
    # 4 KB less n - 1 elements of bf16: the bytes for a destination do not
    # divide, so sm hands the whole call to its flat module, whose blocks
    # are the whole bytes of a destination (the tail is unset)
    odd = mine["bf16 4 KB"][:mine["bf16 4 KB"].numel() - n + 1]
    db = db_like(odd)
    R.call(C, served, "alltoall", "Alltoall bf16 indivisible",
           lambda: C.Alltoall(odd, db))
    per = odd.numel() * 2 // n // 2
    R.check(db.array[:n * per],
            torch.cat([e["bf16 4 KB"][r * per:(r + 1) * per]
                       for e in R.every]), "Alltoall bf16 indivisible")
    if C.coll.providers["allreduce"] != "sm":
        return  # sm declined: nothing of it to time
    # host ms of a 64 MB Allreduce through sm, and through tuned on a Dup
    # that excludes sm, on the same job
    pin = get_var("coll", "coll")
    set_var("coll", "coll", "^sm")
    tw = C.Dup()
    set_var("coll", "coll", pin)
    require(tw.coll.providers["allreduce"] == "tuned",
            "hostcoll: the Dup without sm selects tuned")
    for label, comm in (("sm", C), ("tuned", tw)):
        db = db_like(f32)
        ms = []
        for _ in range(HC_TIMED):
            comm.Barrier()
            _pm_sync(R.device)
            t0 = time.perf_counter()
            comm.Allreduce(f32, db, op=op.SUM)
            db.array
            _pm_sync(R.device)
            ms.append((time.perf_counter() - t0) * 1e3)
        R.check(db, R.total("f32 64 MB"), f"timed Allreduce SUM f32 ({label})")
        timings[f"allreduce_64mb_host_ms_{label}"] = ms
    tw.Free()


def _hc_quant(R, W, job, served):
    """A quant job's verbs: f32 SUM Allreduce at 4 KB and 64 MB, Allgather
    and Reduce_scatter_block at 64 MB (quantized where the verdict is
    active: within the codec's bound of the exact sum on the card, the
    counters grown by what the reference counts; exact otherwise), and a
    bf16 Allreduce, which is not quant-eligible and goes down the slot's
    chain, exact."""
    from ompi_tpu_torch.accelerator import DeviceBuffer
    from ompi_tpu_torch.core import op
    from ompi_tpu_torch.mca.var import all_pvars
    from ompi_tpu_torch.quant.codec import chunk_layout, make_codec

    r, n, mine = R.r, R.n, R.mine
    st = getattr(W, "_quant_state", None)
    active = st is not None and st.active
    codec = make_codec("fp8" if job == "quant_fp8" else "int8", 8, 64)

    def bound(blocks):
        return torch.from_numpy(codec.error_bound(
            torch.stack(blocks).cpu().numpy()))

    def db_like(t, numel=None):
        return DeviceBuffer((t.numel() if numel is None else numel,),
                            t.dtype)

    for size in ("4 KB", "64 MB"):
        key = f"f32 {size}"
        db = db_like(mine[key])
        pv = all_pvars()
        c0, w0 = pv["quant_colls"].value, pv["quant_bytes_wire"].value
        R.call(W, served, "allreduce", f"Allreduce SUM {key}",
               lambda: W.Allreduce(mine[key], db, op=op.SUM))
        exact = R.total(key)
        if not active:
            R.check(db, exact, f"Allreduce SUM {key}")
            continue
        per, _ = chunk_layout(mine[key].numel(), n, codec.block)
        pv = all_pvars()
        require(pv["quant_colls"].value == c0 + 1
                and pv["quant_bytes_wire"].value
                == w0 + 2 * (n - 1) * codec.wire_nbytes(per),
                f"hostcoll rank {r}: the {key} Allreduce counted as the "
                "reference counts it")
        R.bounded(db.array, exact,
                  bound([e[key] for e in R.every]), f"Allreduce SUM {key}")
    db = db_like(mine["bf16 64 MB"])
    R.call(W, served, "allreduce", "Allreduce SUM bf16 64 MB",
           lambda: W.Allreduce(mine["bf16 64 MB"], db, op=op.SUM))
    R.check(db, R.total("bf16 64 MB"), "Allreduce SUM bf16 64 MB")
    f32 = mine["f32 64 MB"]
    ag = db_like(f32)
    R.call(W, served, "allgather", "Allgather f32 64 MB",
           lambda: W.Allgather(R.block(r, "f32 64 MB", r), ag))
    rs = db_like(f32, f32.numel() // n)
    R.call(W, served, "reduce_scatter_block",
           "Reduce_scatter_block SUM f32 64 MB",
           lambda: W.Reduce_scatter_block(f32, rs, op=op.SUM))
    gathered = [R.block(q, "f32 64 MB", q) for q in range(n)]
    mine_parts = [R.block(q, "f32 64 MB", r) for q in range(n)]
    exact = torch.stack([p.to(torch.float32) for p in mine_parts]).sum(0)
    if not active:
        R.check(ag, torch.cat(gathered), "Allgather f32 64 MB")
        R.check(rs, exact, "Reduce_scatter_block SUM f32 64 MB")
        return
    # each sender's block is one encoded vector (a round trip); each block
    # of the reduce-scatter one vector a sender, summed with the f32
    # accumulation slack of the allreduce bound
    R.bounded(ag.array, torch.cat(gathered),
              torch.cat([torch.from_numpy(codec.error_bound(b.cpu().numpy()))
                         for b in gathered]), "Allgather f32 64 MB")
    brs = sum(torch.from_numpy(codec.error_bound(b.cpu().numpy()))
              for b in mine_parts)
    brs = brs.to(R.device) + exact.to(torch.float64).abs() * 4 * (n + 2) \
        * float(np.finfo(np.float32).eps)
    R.bounded(rs.array, exact, brs, "Reduce_scatter_block SUM f32 64 MB")


def hostcoll_rank(device="cuda", scale=1) -> int:
    """One rank of phase 4o (``chip_smoke.py --child hostcoll_rank JOB``
    under the port's ``mpirun``). Prints one ``HC-RANK {json}`` line: for
    each comm, the component that served each call, its providers and
    fallbacks and hier's plan; the checks; on rank 0 the timed
    Allreduces."""
    import platform

    from ompi_tpu_torch.mca.var import all_pvars, get_var, set_var

    t_start = time.perf_counter()
    job = sys.argv[-1]
    if job == "quant_fallback" and os.environ.get("OMPI_TPU_RANK") != "1":
        # every rank but rank 1 asks for the quantized path: its modex card
        # says no, so every rank falls back together
        for name, value in HC_QUANT:
            set_var("quant", name[len("quant_"):], value)

    import ompi_tpu_torch as M
    from ompi_tpu_torch.coll.hier import compose, decide

    W = M.COMM_WORLD
    R = _HcRank(W.Get_rank(), W.Get_size(), device, scale)
    stages = set()  # hier's stages, as they ran
    run = compose._Stager.run

    def staged(self, name, thunk):
        stages.add(f"{self.verb}.{name}")
        return run(self, name, thunk)

    compose._Stager.run = staged
    comms, timings = {}, {}
    q0 = all_pvars()["quant_colls"].value, \
        all_pvars()["quant_bytes_wire"].value
    for name, sets in (HC_SETS if job == "collectives" else ((job, ()),)):
        saved = [(fw, v, get_var(fw, v)) for fw, v, _ in sets]
        for fw, v, value in sets:
            set_var(fw, v, value)
        C = W.Dup() if sets else W
        served = {}
        if job == "collectives":
            _hc_verbs(R, C, name, served, timings)
        else:
            _hc_quant(R, C, job, served)
        comms[name] = {
            "served": served, "providers": dict(C.coll.providers),
            "fallbacks": {k: list(v)
                          for k, v in C.coll.fallback_providers.items()},
            "plans": {v: decide.state_for(C, v).active
                      for v in HC_SERVES["hier"]["hier"]}
            if name == "hier" else {}}
        if C is not W:
            C.Free()
        for fw, v, value in saved:
            set_var(fw, v, value)
    W.Barrier()
    line = {"rank": R.r, "size": R.n, "job": job,
            "machine": platform.machine(),
            "tso": platform.machine() in ("x86_64", "AMD64"),
            "checks": len(R.checks), "comms": comms,
            "stages": sorted(stages),
            "quant_colls": all_pvars()["quant_colls"].value - q0[0],
            "quant_bytes_wire": all_pvars()["quant_bytes_wire"].value
            - q0[1],
            "device": str(R.mine["f32 64 MB"].device),
            "seconds": round(time.perf_counter() - t_start, 2),
            **({"timings": timings} if R.r == 0 else {})}
    print("HC-RANK " + json.dumps(line), flush=True)
    M.Finalize()
    return 0


def _hc_require_served(job, name, c, r0):
    """Each comm's calls went to the component the selection should give:
    sm's slots on an x86_64 host (its decline elsewhere, with the machine
    printed), hier's composition, han and adapt with sm declining, the
    quantized slots and their fallback."""
    prov, served = c["providers"], c["served"]
    serves = HC_SERVES[name]
    if name == "sm" and not r0["tso"]:
        require("sm" not in prov.values(),
                f"hostcoll: sm declines on {r0['machine']}")
        print(f"phase 4o: sm declines on {r0['machine']} (no total store "
              "order); its slots fall to the next component", flush=True)
        serves = {}
    for comp, verbs in serves.items():
        for verb in verbs:
            require(prov[verb] == comp,
                    f"hostcoll: {comp} serves {verb} on the {name} comm "
                    f"({prov[verb]})")
    if name == "sm" and r0["tso"]:
        require(served["Alltoall bf16 indivisible"] == "sm->basic",
                "hostcoll: sm hands an indivisible Alltoall to its flat "
                "module")
    if name == "hier":
        require(set(c["plans"].values()) == {"hier"} and r0["stages"],
                "hostcoll: hier composes each verb")
    if name == "han":
        require("sm" not in prov.values()
                and all("sm" not in v for v in c["fallbacks"].values()),
                "hostcoll: sm declines under coll_han_fake_nodes")
    if job.startswith("quant"):
        want = 0 if job == "quant_fallback" else 4
        require(r0["quant_colls"] == want,
                f"hostcoll: {want} quantized collectives in the {job} job")
        if want == 0:
            require(prov["allreduce"] != "quant",
                    "hostcoll: every rank fell back together")
        else:
            require(served["Allreduce SUM bf16 64 MB"].startswith("quant->"),
                    "hostcoll: bf16 goes down the slot's chain")


def phase_hostcoll(card, device="cuda", scale=1, rank_prog=None):
    """Phase 4o: the rest of the host collectives on the card. The port's
    ``mpirun`` launches ``chip_smoke.py --child hostcoll_rank JOB`` (or
    ``rank_prog``) for each job of ``HC_JOBS``, all sharing the card; a
    rank that fails fails the phase, and so does a call served by another
    component than the selection should give. Prints the component of
    each call, hier's plan, the 64 MB Allreduce's host ms through sm and
    through tuned and the phase's seconds, each with the card, and one
    ``{"hostcoll": ...}`` line."""
    t0 = time.perf_counter()
    prog = rank_prog or [os.path.abspath(__file__), "--child",
                         "hostcoll_rank"]
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    if device == "cpu":  # a rehearsal keeps DeviceBuffers on the host
        env["OMPI_TPU_MCA_accelerator_accelerator"] = "null"
    jobs = []
    for job, n, mca in HC_JOBS:
        cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun", "-np",
               str(n), "--timeout", str(HC_JOB_TIMEOUT_S)]
        for k, v in mca:
            cmd += ["--mca", k, v]
        tj = time.perf_counter()
        p = subprocess.run(cmd + prog + [job], capture_output=True,
                           text=True, timeout=HC_JOB_TIMEOUT_S + 30, env=env,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        dec = json.JSONDecoder()
        ranks = [dec.raw_decode(p.stdout, m.end())[0]
                 for m in re.finditer("HC-RANK ", p.stdout)]
        if p.returncode != 0 or len(ranks) != n:
            print(p.stdout[-4000:], p.stderr[-8000:], file=sys.stderr)
        require(p.returncode == 0, f"hostcoll: the {n}-rank {job} job "
                                   f"exits 0 (rc {p.returncode})")
        require(sorted(x["rank"] for x in ranks) == list(range(n)),
                f"hostcoll: every rank of the {job} job reports")
        require(all(x["device"].startswith(device) for x in ranks),
                f"hostcoll: every rank of the {job} job ran on {device}")
        r0 = next(x for x in ranks if x["rank"] == 0)
        require(all(x["comms"] == r0["comms"] for x in ranks),
                f"hostcoll: the ranks of the {job} job select alike")
        for name, c in r0["comms"].items():
            _hc_require_served(job, name, c, r0)
            label = job if name == job else f"{job}, {name}"
            for what, who in c["served"].items():
                print(f"phase 4o: {n} ranks, {label}: {what} -> {who}",
                      flush=True)
        if "hier" in r0["comms"]:
            print(f"phase 4o: hier's plan: {r0['comms']['hier']['plans']}, "
                  f"stages {', '.join(r0['stages'])}", flush=True)
        jobs.append({"job": job, "ranks": n,
                     "mca": ",".join(f"{k}={v}" for k, v in mca),
                     "machine": r0["machine"], "comms": r0["comms"],
                     "stages": r0["stages"],
                     "checks": sum(x["checks"] for x in ranks),
                     "quant_colls": r0["quant_colls"],
                     "quant_bytes_wire": r0["quant_bytes_wire"],
                     "wall_s": round(time.perf_counter() - tj, 1),
                     "rank_s": max(x["seconds"] for x in ranks),
                     **r0.get("timings", {})})
    secs = time.perf_counter() - t0
    for j in jobs:
        if "allreduce_64mb_host_ms_sm" in j:
            print(f"phase 4o: 64 MB Allreduce host ms ({HC_TIMED} calls), "
                  f"{j['ranks']} ranks over self,sm: sm "
                  f"{j['allreduce_64mb_host_ms_sm']}, tuned "
                  f"{j['allreduce_64mb_host_ms_tuned']} on {card}",
                  flush=True)
    print(json.dumps({"hostcoll": {"card": card, "scale": scale,
                                   "jobs": jobs,
                                   "phase_s": round(secs, 1)}}), flush=True)
    print(f"phase 4o: {len(jobs)} jobs, "
          f"{sum(j['checks'] for j in jobs)} checks on the card; "
          f"{secs:.1f} s on {card}", flush=True)
    return jobs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the flagship forward's and training "
                         "step's kernels")
    ap.add_argument("--child", choices=sorted(OBS_CHILDREN)
                    + ["bind_rank", "procmode_rank", "coll_rank",
                       "hostcoll_rank"],
                    help=argparse.SUPPRESS)  # 4i's, 4k's, 4m's to 4o's
    ap.add_argument("mode", nargs="?", help=argparse.SUPPRESS)  # 4n's, 4o's
    args = ap.parse_args()
    if args.child == "bind_rank":  # 4k's child reads the host, not the card
        return bind_child()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.child == "procmode_rank":  # 4m's ranks, under the port's mpirun
        return procmode_rank()
    if args.child == "coll_rank":  # 4n's ranks, under the port's mpirun
        return coll_rank()
    if args.child == "hostcoll_rank":  # 4o's ranks, under the port's mpirun
        return hostcoll_rank()
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
    phase_typed(card)
    phase_diagnostics(card)
    phase_btl(card)
    phase_procmode(card)
    phase_collstack(card)
    phase_hostcoll(card)

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
