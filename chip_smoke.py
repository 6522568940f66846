#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build its CUDA kernels from the
sources in this checkout, hold each kernel against its plain PyTorch version
at the shapes its path gives it, drill ABFT detection and correction on the
card, serve Qwen2-0.5B at its published width through the port's serving
entry point, run the paper's fault-tolerant SUMMA at the paper's size, and
train Qwen2-0.5B at its published width through the port's fault-tolerant
training entry point, with diskless recoveries, hold the checked
flash-attention kernel against its plain version at the Qwen2-0.5B and
Gemma2-2B attention shapes, run the chaos campaign over its train, serve
and solver workloads through its CLI, and drive the protected reductions
and the at-rest scrub at full width: the verified unembed of the serving
engine with an SDC drill and KV and params flips, and the protected train
step under ElasticRuntime with an SDC and DRAM flips, and serve an open-loop
traffic trace at full width on the paged engine (page checksums on the
device, SLO scheduler, prefix cache, chunked prefill) clean and drilled,
against the contiguous engine, with the traffic campaign and the
telemetry recorder, and solve a 24576-unknown float64 Poisson system with
the redundant-subspace CG solver, clean and drilled, and protect the
full-width params with the FT context in its three encodings, and serve
and run the LM's other families at their published widths: MoE, the
Mamba/attention hybrid, xLSTM, Whisper's encoder-decoder and the vision
config's cross attention, and train Qwen2-0.5B at full width through the
pod-loss drill on a logical (pod, data, model) mesh: shrink, resume and
re-grow, with loss parity against a survivor mesh built from scratch,
and tune kernels #1 and #2 with the measured autotuner, train it
compressed (int8 error feedback, ZeRO-2, FSDP), plan its cells with the
dry run against two of them run for real, and serve Whisper-large-v3
through the step builders.

    python3 chip_smoke.py

Phases (one line or more each; any failed check raises, and the script
exits non-zero without printing a result):
  1. device   — a CUDA card, and its name and power limit from nvidia-smi;
  2. build    — nvcc builds kernels/csrc/abft_matmul.cu,
                abft_matmul_acc.cu, checksum_encode.cu and
                flash_attention.cu (sm_90a), one process each, at once;
  3. kernel   — the kernel against its plain version at the serving shapes
                (m = 4 decode on the split-k route, m = 1024 prefill bucket
                on tensor-core tiles; fp32 and bf16, one int8 shape), the
                training shapes (m = 2048, fp32) and ragged shapes (m = 5,
                k = 900, n = 130; m = 1000, n = 898; every operand type),
                each row with its route, tile, split count and copy widths;
                two calls bit-identical; kernel, plain and torch.matmul
                times of eager calls and the bound at the tensor-core rate
                (3xTF32 for fp32) and at the CUDA-core rate;
  4. drill    — a corrupted checksum column is detected by the fused verify
                on the kernel; a 1e4 flip in a kernel-computed output is
                flagged, located and corrected;
  5. serve    — repro_torch.launch.serve.run at full width in bf16, ABFT
                verify on the default backend (the kernel on the card): 8
                requests, launch count 168 x (prefills + decode steps), no
                plain-version call; each prefill's logits against the
                plain path within a tolerance measured from fp32
                activations, and every first token equal to its argmax;
  6. acc      — the accumulate kernel against its plain version on both
                routes: tensor-core tiles at the SUMMA step shape (3072^3:
                fp32, bf16 and int8 operands; fp32 also in place, as the
                SUMMA calls it) and a ragged, misaligned 1000 x 900 x 898
                (every operand type), CUDA cores at a ragged shape and the
                chaos campaign's 256^3 drills on the 32 x 32 tiles its
                runner plans (fp32, bf16, int8); each row with its route,
                tile and copy widths, two calls bit-identical, kernel,
                plain, torch.addmm and bound times; a clean two-call chain
                re-verifies with residual exactly 0; flip drills on the
                tensor-core tile: five single flips located and
                repaired, two flips in two tiles, an int8 data flip repaired
                bit-exactly, a carried-ccol flip detected and not repaired;
  7. summa    — repro_torch.core.abft_summa on an 8 x 8 grid of 3072 blocks
                (the paper's p = 64, f = 1): clean, a failure, a double
                failure, a mid-loop flip and a last-step flip, each passing
                the paper's residual check and verify() with 512 kernel
                launches and no plain call; the plain-SUMMA walls (kernel
                with verify off, and torch.matmul) on 24576^2 operands; the
                stress CLI for 8 iterations;
  8. encode   — the diskless encode kernel against its plain version at the
                full-width train state's own views (the embedding in bf16
                and fp32, a 4-D layer-group view, a [4, 224] norm view), a
                ragged p = 16, f = 3 case, and the p = 1 views that
                ElasticRuntime at 1 x 1 encodes (embedding, a layer group,
                a norm; there the output is the state bit for bit), with
                kernel, plain, torch.matmul and bound times, and the same
                sums over one encode of the whole state (42 leaves);
  9. train    — repro_torch.launch.train.run at full width in bf16, ABFT
                verify: 30 steps with two injected shard losses and a
                diskless encode every 5 steps; kernel #3 launched once per
                floating leaf per encode and kernel #1 168 times per forward
                pass (twice per step: remat recomputes the blocks), no
                plain-version call; 2 diskless recoveries, each replayed step
                close to its first pass, the loss falling; verify, a flip,
                reshard and the bf16 recovery error on the held checkpoint;
                a resume from the disk checkpoint, bit-identical;
 10. flash    — the checked flash-attention kernel against its plain
                version at Qwen2-0.5B's attention (4 x 14 heads, S 4096,
                D 64, causal; fp32 and bf16, plain and checked), Gemma2-2B's
                local attention (2 x 8 heads, S 8192, D 256, window 4096,
                softcap 50, bf16, checked), a rectangular non-causal
                256 x 1024 case, the chaos campaign's drill shape (2
                heads, S 512, D 64, causal, fp32, bq = bk = 128, plain and
                checked) and B.H = 65,540 heads of S 64, D 64 (past
                grid.y's 65,535; plain and checked), each row on the
                tensor-core route and its planned tile (asserted), with
                kernel, plain, SDPA in the same dtype (where one call
                computes the same function) and bound times (fp32 at the
                3xTF32 and the CUDA-core rate); every tile (D 64, 128,
                256; fp32 and bf16) once at a small shape; a clean checked
                run flags nothing; injects into acc and l before, on and
                past the diagonal, a NaN into acc, and a NaN and a -1e4
                into l (which leave l dead: the plain version flags those
                two as well) are flagged at their tile and repaired;
 11. chaos    — kernels #4 and #2 against their plain versions on each of
                the campaign's eight kernel drills (its inputs, tiles and
                faults, clean and faulted calls); then
                repro_torch.launch.chaos --check over the default space's
                train, serve and solver workloads (--workload all), counts
                zeroed just before it: its 103 rows (74 train and serve, 29
                solver) with the outcome, rung and end state of the
                reference's 8-device campaign (CAMPAIGN_ROWS: the 98 rows
                of CAMPAIGN_PR7.json and the five dtype-variant kernel
                rows; 89 corrected, 1 absorbed, 3 detected, 10 clean
                sweeps, none skipped: shard loss, pod loss through rungs 3a
                and 3b with re-grow and a slow pod demoted on the logical
                (2, 2, 2) pod mesh, the serve rows on the logical (4, 2)
                mesh; episodes 17 corrected, the six solver episodes among
                them; the solver's sustained rate at parity 400 events per
                1k iterations), kernel #4 launched 4 and kernel #2 21
                times, kernel #3 once per encoded leaf of every diskless
                encode, re-key and scrub verify (the solver launches none),
                no plain call, nothing missed, no false alarm, the
                uncovered ledger empty and the gate passing (the artifact
                and matrix in chiprun_out/chaos.*);
 12. serve-ft — repro_torch.launch.serve.run on Qwen2-0.5B at full width in
                fp32 (the bit-flip model is on 32-bit words), ABFT verify
                on kernel #1 (168 launches a pass, no plain call), 8
                requests: the protected logits reduction ("correct") clean;
                an SDC drill at decode step 3 (shard 0, delta 1e4)
                detected, corrected and located, tokens identical to the
                undrilled run; with the scrub every decode step, a KV flip
                and a params flip (the campaign's _flip_engine_bit)
                repaired, tokens identical, and the protected tokens equal
                to the unprotected run's; the reduction's share of a decode
                step from an unprotected and a protected engine on the same
                weights and requests, stepped in turns, and the reduction
                alone on CUDA events; the drilled step's recovery latency
                and the scrub's wall;
 13. train-ft — ElasticRuntime (mesh 1 x 1) on Qwen2-0.5B at full width in
                fp32, batch 16 x seq 128, the protected step (deferred
                reduction, abft_reduce "correct", ABFT verify) with an
                encode and a scrub every step for 6 steps: an SDC at step 2
                flagged (abft_ok 0), a params flip at step 3 and an
                optimizer-state flip at step 4 rolled back by the scrub,
                the end state within TrainConfig.tol of the clean run's;
                kernel #3 launched once per leaf (42) of each encode and
                each verify, no plain call; the reduction's share of a step
                from unprotected and protected steps on one state and batch
                in turns, and the reduction alone on CUDA events; encode
                and verify walls;
 14. traffic  — PagedServeEngine on Qwen2-0.5B at full width in fp32 (8
                slots of 2048 tokens in pages of 16: two K/V pools of
                403 MB with their float64 page checksums on the card), ABFT
                verify on kernel #1, the protected logits reduction, a page
                scrub every decode step, chunked prefill of 256, the prefix
                cache and the SLO scheduler, replaying serve.traffic's
                open-loop trace of 24 requests behind a 256-token system
                prompt: (a) clean, kernel #1 launched 168 times a decode
                step and a prefill pass, no plain call, counts zeroed just
                before; (b) the same trace under two SDCs on the logits
                reduction and two page flips at the executed steps
                launch/obs.py picks, 4/4 detected and corrected, tokens
                equal to (a)'s; (c) unchunked, no prefix cache or
                scheduler, against the contiguous ServeEngine on the same
                weights (paged, contiguous, contiguous, paged), tokens
                identical, whole-step medians and the gather and write-back
                on their own; (d) the chaos CLI over the traffic workload
                (rows equal to its CPU run's) and `launch.obs record
                --check` (4 lifecycles, 0 dropped, 0 missed, overhead under
                2 %); p50/p99 TTFT, tokens/s, the page scrub's wall, prefix
                hits and pool bytes printed;
 15. solver   — RedundantSubspaceCG on the 1D Poisson system at n = 24576
                (12 subspaces of 2 x 2048 unknowns, two replicas on three
                simulated pods) in float64 on the card: (a) clean,
                converged with zero trips, x within 1e-8 of RandomState(0)'s
                x_true and A x within 1e-8 of b; (b) drilled with an SDC in
                subspace 3 replica 0 at iteration 2, a flip of argmax |x|
                and the loss of pod 1 at iteration 3, converged through a
                replica repair, a guard restart and failovers; iterations,
                wall an iteration (synchronized), bytes held and
                max |x - x_clean| printed; (c) FTContext(p = 4) over the
                seeded full-width Qwen2-0.5B params in fp32, each leaf
                viewed [4, numel / 4]: floating_point (f = 1, 2), gf256
                (f = 1, 2) and xor (f = 1), shard 2 (shards 1 and 3 for
                f = 2) lost and recovered, gf256 and xor bit for bit,
                floating_point within 1e-5 of max |leaf|; register and
                recover walls printed;
 16. families — ABFT verify on kernel #1 (launches counted per block kind,
                counts zeroed at each engine's warm-up, no plain call):
                (a) Qwen3-30B-A3B whole (48 layers, 128 experts top-8,
                bf16, 61 GB) through repro_torch.launch.serve.run, 8
                requests of 16-128 tokens, 16 new, 4 slots: each first
                token the kernel path's argmax and within phase 5's
                tolerance of the plain path's maximum (its fp32 path cast
                one layer at a time), the decode step against the floor of
                reading every expert; (b) Jamba-1.5-Large's period cut to
                its first four blocks (mamba and attention, dense and MoE)
                at d_model 8192 in bf16, prompts of 37, 77, 100 and 123
                tokens, and (c) xLSTM-350M whole in fp32, 8 requests: one
                request's tokens held to greedy decoding by the full
                forward (a near tie within 2 x the kernel-plain noise
                allowed); (d) Whisper-large-v3 whole in fp32 (a forward of
                2 x 64 tokens over 1500 seeded frames, verify against off
                within 2 x the TF32 noise; a prefill of 8 and 8 decode
                steps over the cached cross K/V within 2e-3 x scale of the
                forward) and Llama-3.2-Vision-11B whole in bf16 (a
                forward over 1024 seeded image embeddings, verify against
                off within 2 x the fp32 copy's noise); peak memory,
                prefill and decode-step walls printed;
 17. elastic  — repro_torch.launch.train.run_elastic_drill on Qwen2-0.5B at
                full width in fp32 (5.93 GB of train state), batch 16 x seq
                128, kernel #3 for every diskless encode (counts zeroed
                just before (a), read after (b), no plain call): (a) on
                the logical (2, 2, 2) mesh, 10 steps, a pod lost at step 4
                (rung 3b: disk restore at step 3 onto (2, 2)), re-grown at
                step 8 onto generation 0's step, a disk save every 3 steps
                (5 saves, under a temporary directory of build/ removed at
                the end): params after the restore bit for bit the
                from-scratch reference's, max |dloss| 0.0 over the 5
                compared steps; (b) on (2, 1, 1), 5 steps, a pod lost at
                step 2 (rung 3a: the diskless checkpoint solved and
                re-encoded at p = 1): params within 1e-4 and losses within
                1e-3 of the disk-restored reference; (c) kernel #3 against
                its plain version on the p = 4 and p = 2 states the drills
                encoded, kernel, plain, torch.matmul and bound times of one
                whole-state encode; (d) each transition's report (bytes
                moved and re-specced, reshard and build walls), the step
                wall at each DP extent and peak memory;
 18. tuning   — (a) repro_torch.launch.autotune.main in-process on the
                bench set and Qwen2-0.5B's served projection shapes (m =
                1024 and 4; fp32, bf16, int8; family one, kernel #1),
                then kernels.autotune on the SUMMA's 3072^3 accumulate
                shape (require_exact, kernel #2), into the run's own
                cache (main sets REPRO_TORCH_AUTOTUNE_CACHE to a fresh
                file first, so phases 1-17 plan cold): per key the
                model plan's and the winner's times, blocks and route;
                every winner held to its plain version (phases 3 and 6
                tolerances); a warm re-run with 0 measurements; a
                protected projection and a SUMMA step (grid 2 of 3072
                blocks) from the cache; the host time of one dispatch,
                best_plan warm and cold beside pick_blocks; (b)
                Qwen2-0.5B at full width in fp32, batch 16 x seq 128, on
                the logical (1, 4, 1) mesh through ElasticRuntime, 10
                steps each from one seeded state: int8-EF with zero2
                (an encode at steps 0 and 5 on kernel #3, ef_residual
                included), deferred, zero2 and fsdp; every compressed
                reduction within int8 error feedback's bounds (each new
                residual within half a level of its shard's scale, the
                mean within the mean half level of the exact mean), the
                compressed run converging (its loss falls at least half
                as far as the uncompressed run's over the 10 steps) and
                its loss gap to the uncompressed run printed; zero2 and
                fsdp bit for bit; (c) launch.dryrun of every valid Qwen2-0.5B
                cell on pod1 and pod2 (meta tensors, a process of its own
                beside (a) and (b)); train_4k cut to a global batch of 2
                on (1, 1) with remat (the FA-2 backward at seq 4096) and
                decode_32k cut to batch 1 (a prefill of 4096 tokens, 4
                decode steps) run for real through the builders, the dry
                run's argument + temp bytes and FLOPs beside the measured
                peak and walls; the attention backward's peak memory,
                FA-2 against autograd through the chunk loop; (d)
                Whisper-large-v3 in fp32 through build_prefill_step and
                build_serve_step (a prefill of 2 x 8 over 1500 frames, 8
                greedy decode steps, ABFT verify on kernel #1: 2,217
                launches, no plain call), the tokens held to greedy
                decoding by the full forward (phase 16's rule).
The line before the last is the per-kernel JSON record, the last line the
device record.  Details go to chiprun_out/chip_smoke.json.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_HBM_BPS = 3.35e12        # bytes/s, H100 SXM data sheet
PEAK_OPS = {                  # dense peak rates, H100 SXM data sheet
    "float32": 495e12 / 3,    # tensor cores in 3xTF32 (fp32-level error)
    "bfloat16": 989e12,       # tensor cores
    "int8": 1979e12,          # tensor cores
}
CUDA_CORE_FP32 = 67e12        # fp32 FMA outside the tensor cores
SERVE_SHAPES = [             # (k, n_enc, projections per layer)
    (896, 898, 2),           # q, o   (d_model + 2 checksum columns)
    (896, 130, 2),           # k, v   (2 KV heads x 64 + 2)
    (896, 4866, 2),          # gate, up
    (4864, 898, 1),          # down
]
TRAIN_M = 2048                # batch 16 x seq 128 of the training phase
RAGGED_SHAPES = [(5, 900, 130), (1000, 900, 898)]   # (m, k, n)
RTOL = 1e-5   # fp32 accumulation in both, sums in another order


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps, flush):
    """Mean device time of one call, CUDA events around each call, with
    the 50 MB L2 flushed before it (the serving path reads every weight
    cold: one layer's weights outgrow L2 several times over per step).
    The call is eager, as the serving and training paths make it: where
    the host takes longer to issue it than the flush takes to run, the
    events also see that host time."""
    for _ in range(2):
        fn()
    ts = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return sum(ts) / len(ts)


def within(x, ref, scale):
    """Elementwise |x - ref| <= RTOL * |ref| + RTOL * scale."""
    return bool(((x - ref).abs() <= RTOL * ref.abs() + RTOL * scale).all())


def bound(torch, m, k, n, f, in_dtype, out_bytes, plan):
    """Least time of the same work on the card: every input read once,
    every output written once, over HBM; 2mkn + 4fmn operations over the
    peak rate of the operand type.  Returns (ms, "bytes" or "operations",
    ms with fp32 operations at the CUDA-core rate instead)."""
    in_b = torch.empty((), dtype=in_dtype).element_size()
    mt, nt = -(-m // plan.bm), -(-n // plan.bn)
    nbytes = (m * k + k * n) * in_b + (f * m + n * f) * 4 \
        + m * n * out_bytes + (mt * f * n + nt * m * f) * 4
    ops = 2 * m * k * n + 4 * f * m * n
    name = str(in_dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / H100_HBM_BPS, ops / PEAK_OPS[name]
    t_cuda = ops / CUDA_CORE_FP32 if name == "float32" else t_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), \
        1e3 * max(t_bytes, t_cuda)


def hold_oneshot(torch, kmm, args, kw, got):
    """Kernel #1's outputs ``got`` on ``args`` = (a, b, wm, wn) against its
    plain version on the same inputs -> (max |c - plain|, checksum column
    and row errors).  c within ``within`` of the plain c (int8: bit-exact);
    the checksums are sums of terms |c| |w| and the residual direction
    ([w_r; -I]) cancels them, so their tolerance scales with the terms."""
    a, b, wm, wn = args
    c, ccol, crow = got
    what = (tuple(a.shape), tuple(b.shape), a.dtype)
    plain_kw = {key: v for key, v in kw.items() if key != "splits"}
    cp, ccolp, crowp = kmm.abft_matmul_plain(a, b, wm, wn, **plain_kw)
    c32, cp32 = c.double(), cp.double()
    err_c = float((c32 - cp32).abs().max())
    if a.dtype == torch.int8:
        if not torch.equal(c, cp):
            raise AssertionError(f"int8 c not bit-exact at {what}")
    elif not within(c32, cp32, float(cp32.abs().max())):
        raise AssertionError(f"c differs at {what}: {err_c}")
    cs_col, cs_colp = ccol.sum(0).double(), ccolp.sum(0).double()
    cs_row, cs_rowp = crow.sum(0).double(), crowp.sum(0).double()
    terms_col = float((wm.abs().double() @ cp32.abs()).max())
    terms_row = float((cp32.abs() @ wn.abs().double()).max())
    err_col = float((cs_col - cs_colp).abs().max())
    err_row = float((cs_row - cs_rowp).abs().max())
    if not (within(cs_col, cs_colp, terms_col)
            and within(cs_row, cs_rowp, terms_row)):
        raise AssertionError(f"checksums differ at {what}: "
                             f"{err_col} / {err_row}")
    return err_c, err_col, err_row


def kernel_cases(torch):
    """(m, k, n, projections per served layer, dtype, set) of phase 3: the
    serving shapes at decode and prefill (fp32, bf16), one int8 shape, the
    training shapes (fp32) and ragged shapes (every operand type)."""
    cases = [(m, k, n, mult, dt, "serve") for m in (4, 1024)
             for k, n, mult in SERVE_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((1024, 4864, 896, 0, torch.int8, "int8"))
    cases += [(TRAIN_M, k, n, 0, torch.float32, "train")
              for k, n, _ in SERVE_SHAPES]
    cases += [(m, k, n, 0, dt, "ragged") for m, k, n in RAGGED_SHAPES
              for dt in (torch.float32, torch.bfloat16, torch.int8)]
    return cases


def phase_kernel(torch, record):
    """Kernel #1 against its plain version at every case of
    ``kernel_cases``, on the route and tile the planner gives it; two calls
    bit-identical; timed against the plain version and torch.matmul."""
    from repro_torch.core.abft_gemm import _residual_weights
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                        device="cuda")          # 128 MB > the 50 MB L2
    rows = []
    for m, k, n, mult, dt, what in kernel_cases(torch):
        if dt == torch.int8:
            a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                              dtype=torch.int8)
            b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                              dtype=torch.int8)
            wn = ops.kernel_weights(n, device="cuda").T.contiguous()
            out = torch.int32
        else:
            a = torch.randn((m, k), generator=g, device="cuda").to(dt)
            b = (torch.randn((k, n), generator=g, device="cuda")
                 * k ** -0.5).to(dt)
            wn = _residual_weights(n - 2, 2, 17, "cuda:0")   # [w_r; -I]
            out = torch.float32
        wm = ops.kernel_weights(m, device="cuda")
        plan = ops.pick_blocks(m, k, n, in_dtype=dt,
                               out_bytes=4, f=2)
        kw = dict(bm=plan.bm, bn=plan.bn, bk=plan.bk, out_dtype=out)
        c, ccol, crow = kmm.abft_matmul_cuda(a, b, wm, wn, **kw)
        route = dict(kmm.last_route)
        again = kmm.abft_matmul_cuda(a, b, wm, wn, **kw)
        torch.cuda.synchronize()
        if route["route"] != plan.route or route["splits"] != plan.splits:
            raise AssertionError(f"{(m, k, n, dt)} ran {route}, planned "
                                 f"{plan.route} with {plan.splits} splits")
        if not all(torch.equal(x, y) for x, y in zip((c, ccol, crow), again)):
            raise AssertionError(f"two calls differ at {(m, k, n, dt)}")
        err_c, err_col, err_row = hold_oneshot(
            torch, kmm, (a, b, wm, wn), kw, (c, ccol, crow))
        row = dict(m=m, k=k, n=n, dtype=str(dt).replace("torch.", ""),
                   set=what, per_layer=mult, tile=[plan.bm, plan.bn],
                   route=route["route"], splits=route["splits"],
                   copy_bytes=[route["copy_a"], route["copy_b"]],
                   max_abs_err=err_c, err_cs_col=err_col, err_cs_row=err_row,
                   repeat_bit_identical=True)
        reps = 20 if m <= 32 else 10
        row["ms"] = time_ms(
            torch, lambda: kmm.abft_matmul_cuda(a, b, wm, wn, **kw), reps,
            flush)
        row["plain_ms"] = time_ms(
            torch, lambda: kmm.abft_matmul_plain(a, b, wm, wn, **kw), reps,
            flush)
        row["library_ms"] = None
        if dt != torch.int8:
            row["library_ms"] = time_ms(torch, lambda: torch.matmul(a, b),
                                        reps, flush)
        row["bound_ms"], row["bound_by"], row["bound_cuda_core_ms"] = \
            bound(torch, m, k, n, 2, dt, out.itemsize, plan)
        rows.append(row)
        log("kernel", json.dumps(row))
        del a, b, c, ccol, crow, again
    record["kernel_cases"] = rows
    return rows


def phase_drill(torch, record):
    from repro_torch.core import abft_gemm as ag
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(1)
    cfg = ag.ABFTConfig(mode="verify")      # backend "auto": the kernel
    w = torch.randn((896, 896), generator=g, device="cuda") * 896 ** -0.5
    x = torch.randn((128, 896), generator=g, device="cuda")
    w_enc = ag.encode_weight(w, cfg)
    before = kmm.launches
    _, ok_clean = ag.abft_matmul(x, w_enc, cfg)
    w_bad = w_enc.clone()
    w_bad[100, 896] += 50.0            # a checksum-column element
    _, ok_bad = ag.abft_matmul(x, w_bad, cfg)
    if kmm.launches - before != 2:
        raise AssertionError("the fused verify (backend auto) did not run "
                             "on the kernel")
    if not bool(ok_clean) or bool(ok_bad):
        raise AssertionError(f"checksum-column drill: clean ok={bool(ok_clean)}"
                             f", corrupted ok={bool(ok_bad)}")
    log("drill", "corrupted checksum column: clean ok=True, corrupted "
                 "ok=False (fused verify on the kernel)")

    y_f, res = ag._fused_forward(x, w_enc, cfg)
    y, ycs = y_f[:, :-2], y_f[:, -2:]
    r, c = 77, 401
    y_bad = y.clone()
    y_bad[r, c] += 1e4
    ok, res_bad = ag.verify_output(y_bad, ycs, cfg)
    if bool(ok):
        raise AssertionError("1e4 flip not flagged by verify_output")
    fixed = ag.correct_output(y_bad, ycs, res_bad,
                              ag.ABFTConfig(mode="correct"))
    moved = torch.nonzero((fixed - y_bad).abs() > 1.0).tolist()
    err = float((fixed - y).abs().max())
    if moved != [[r, c]] or err > 1e-2:
        raise AssertionError(f"correction moved {moved}, max err {err}")
    log("drill", f"1e4 flip at ({r},{c}) of a kernel output: flagged, "
                 f"located at {tuple(moved[0])}, max |fixed - clean| = {err:.3g}")
    record["drill"] = {"checksum_column": "detected", "flip_located": [r, c],
                       "flip_residual_err": err}


def _to_fp32(tree):
    """A copy of a param tree with every floating tensor in fp32."""
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_fp32(v) for v in tree)
    if hasattr(tree, "is_floating_point") and tree.is_floating_point():
        return tree.float()
    return tree


def phase_serve(torch, record, name):
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.core.abft_gemm import ABFTConfig
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.launch.serve import run
    from repro_torch.models import transformer as tf

    cfg = get_config("qwen2-0.5b")
    per_pass = 7 * cfg.n_layers                      # 168 protected GEMMs
    rs = np.random.RandomState(0)
    lens = rs.randint(16, 1001, size=8)
    # one prompt of 1000 makes max_len > 1024, so the prefill attends over
    # a cache longer than flash_threshold and takes the chunked path
    lens[rs.randint(8)] = 1000
    counts = {}

    def on_warm(engine):
        kmm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        counts["t0"] = time.perf_counter()

    # the default ABFT backend ("auto"), which on the card is the kernel
    finished, engine = run("qwen2-0.5b", smoke=False, requests=8, slots=4,
                           prompt_lens=lens.tolist(), gen=32,
                           abft_mode="verify", kernel_dtype="fp32",
                           device="cuda", on_warm=on_warm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - counts["t0"]
    launches, plain = kmm.launches, kmm.plain_calls
    st = engine.stats
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(finished) != 8 or any(len(r.output) != 32 for r in finished):
        raise AssertionError("not every request finished with 32 tokens")
    want = per_pass * (st.prefills + st.decode_steps)
    if launches != want or plain != 0:
        raise AssertionError(f"kernel launches {launches} != {want} or plain "
                             f"calls {plain} != 0")
    s = st.summary()
    log("serve", f"{name}: 8/8 requests, {st.prefills} prefills, "
                 f"{st.decode_steps} decode steps, kernel launches {launches}"
                 f" = {per_pass} x {st.prefills + st.decode_steps}, plain 0")
    log("serve", f"TTFT mean {s['ttft_ms']:.1f} ms, decode "
                 f"{s['tok_per_s']:.1f} tok/s per request, mean decode step "
                 f"{s['clean_step_ms']:.2f} ms, peak memory {peak_gb:.2f} GB,"
                 f" wall {wall:.1f} s, max_len {engine.max_len}")

    # Each prompt's prefill again, three ways: the kernel path as served,
    # the plain path (backend "ref": torch.matmul + verify_output) with the
    # same bf16 activations, and the plain path with fp32 activations and
    # fp32 copies of the weights.  The two bf16 paths sum each product in
    # another order, so a bf16 rounding between layers can land one ulp
    # apart and carry through 24 layers.  Each bf16 path lies about
    # noise = max|plain bf16 - plain fp32| from the fp32 path, so the two
    # may differ by up to 2 x noise (triangle inequality): that is the
    # tolerance, measured on every prompt.  The first token of every
    # request must be the plain path's argmax.
    ref_cfg = ABFTConfig(mode="verify", backend="ref")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _to_fp32(engine.params)
    checks = []
    with torch.no_grad():
        for req in sorted(finished, key=lambda r: r.rid):
            plen = len(req.prompt)
            tok = torch.zeros((1, engine._bucket(plen)), dtype=torch.int64,
                              device="cuda")
            tok[0, :plen] = torch.tensor(req.prompt)

            def prefill(params, c, abft):
                cache = tf.init_cache(c, 1, engine.max_len, device="cuda")
                return tf.forward(params, tok, c, cache=cache,
                                  abft=abft)[0][0, :plen]

            lk = prefill(engine.params, cfg, engine.abft)
            lp = prefill(engine.params, cfg, ref_cfg)
            l32 = prefill(params32, cfg32, ref_cfg)
            gap = float((lk - lp).abs().max())
            noise = float((lp - l32).abs().max())
            row = dict(rid=req.rid, plen=plen, gap=gap, tol=2 * noise,
                       noise=noise, kernel_vs_fp32=float((lk - l32).abs()
                                                         .max()),
                       max_abs_logit=float(lp.abs().max()),
                       first=req.output[0], plain_argmax=int(lp[-1].argmax()),
                       kernel_argmax=int(lk[-1].argmax()))
            checks.append(row)
            log("serve", "prefill check " + json.dumps(row))
            if gap > 2 * noise:
                raise AssertionError(f"request {req.rid}: kernel-path logits "
                                     f"differ by {gap} > 2 x {noise}")
            if not row["first"] == row["plain_argmax"] == row["kernel_argmax"]:
                raise AssertionError(f"request {req.rid}: first token "
                                     f"{row['first']}, plain argmax "
                                     f"{row['plain_argmax']}, kernel argmax "
                                     f"{row['kernel_argmax']}")
    worst = max(checks, key=lambda r: r["gap"] / (r["tol"] or 1.0))
    log("serve", f"plain-path prefills: first tokens agree 8/8; worst "
                 f"|logits diff| / tolerance = {worst['gap']:.4g} / "
                 f"{worst['tol']:.4g} (request {worst['rid']}, max |logit| "
                 f"{worst['max_abs_logit']:.4g})")
    record["serve"] = dict(summary=s, prefills=st.prefills,
                           decode_steps=st.decode_steps, launches=launches,
                           plain_calls=plain, peak_gb=peak_gb, wall_s=wall,
                           prompt_lens=lens.tolist(), max_len=engine.max_len,
                           prefill_checks=checks, card=name)
    return launches


def phase_build(torch, record):
    """nvcc on every kernel source of the path, one process each, at once."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.compile_all(build.SOURCES)
    secs = time.perf_counter() - t0
    record["build"] = {"seconds": secs}
    for src in build.SOURCES:
        build.load(src)
        entry = build.BUILD_LOG[src]
        regs = [ln.strip() for ln in entry["log"].splitlines()
                if "registers" in ln]
        log("build", f"{src}.cu built in {entry['seconds']:.1f} s "
                     f"({len(regs)} kernels; {regs[-1] if regs else 'reused'})")
        record["build"][src] = entry
    log("build", f"{len(build.SOURCES)} sources built in {secs:.1f} s (in "
                 "parallel)")


ACC_CASES = [       # (m, k, n, operand dtype, pinned tile, in place)
    (3072, 3072, 3072, "float32", None, False),    # the SUMMA step
    (3072, 3072, 3072, "bfloat16", None, False),
    (3072, 3072, 3072, "int8", None, False),
    (3072, 3072, 3072, "float32", None, True),     # as the SUMMA calls it
    # ragged and misaligned on the tensor-core route: 898 fp32 columns are
    # 8 mod 16 bytes a row
    (1000, 900, 898, "float32", (128, 64), False),
    (1000, 900, 898, "bfloat16", (128, 64), False),
    (1000, 900, 898, "int8", (128, 64), False),
    (200, 136, 328, "float32", (64, 64), False),   # ragged, CUDA cores
    # the chaos campaign's drills, on the tiles its runner plans (32 x 32)
    (256, 256, 256, "float32", "campaign", False),
    (256, 256, 256, "bfloat16", "campaign", False),
    (256, 256, 256, "int8", "campaign", False),
]


def acc_bound(m, k, n, f, in_dtype, out_bytes, bm, bn):
    """Least time of one accumulate step: A, B, C_in, both weight matrices
    and the carried state read once, C_out, the new state and the stats
    written once; 2mkn + 4fmn (epilogue checksums) + 4mn (the prologue's
    plain-sum residuals on clean data) operations at the operand type's
    peak."""
    in_b = {"float32": 4, "bfloat16": 2, "int8": 1}[in_dtype]
    mt, nt = -(-m // bm), -(-n // bn)
    state = (mt * f * n + nt * m * f) * 4
    nbytes = ((m * k + k * n) * in_b + 2 * m * n * out_bytes
              + (f * m + n * f) * 4 + 2 * state + mt * nt * 8 * 4)
    ops = 2 * m * k * n + 4 * f * m * n + 4 * m * n
    t_bytes, t_ops = nbytes / H100_HBM_BPS, ops / PEAK_OPS[in_dtype]
    t_cuda = ops / CUDA_CORE_FP32 if in_dtype == "float32" else t_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), \
        1e3 * max(t_bytes, t_cuda)


def acc_zero_state(torch, m, n, bm, bn, f=2):
    """The carried state of C = 0 under a (bm, bn) tiling."""
    return (torch.zeros((-(-m // bm), f, n), device="cuda"),
            torch.zeros((-(-n // bn), m, f), device="cuda"))


def _acc_inputs(torch, g, m, k, n, dt):
    if dt == torch.int8:
        a = torch.randint(-8, 9, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-8, 9, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        return a, b, torch.int32
    a = torch.randn((m, k), generator=g, device="cuda").to(dt)
    b = torch.randn((k, n), generator=g, device="cuda").to(dt)
    return a, b, torch.float32


def phase_acc(torch, record):
    from repro_torch.chaos.campaign import CampaignRunner
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for m, k, n, name, tile, in_place in ACC_CASES:
        dt = getattr(torch, name)
        if tile is None:
            plan = ops.pick_blocks(m, k, n, in_dtype=dt, out_bytes=4,
                                   carry=True, require_exact=True)
            tile = (plan.bm, plan.bn)
        elif tile == "campaign":
            plan = CampaignRunner._acc_plan(m, k, n)
            tile = (plan.bm, plan.bn)
        bm, bn = tile
        wm = ops.kernel_weights(m, device="cuda")
        wn = ops.kernel_weights(n, device="cuda").T.contiguous()
        a0, b0, out = _acc_inputs(torch, g, m, k, n, dt)
        a, b, _ = _acc_inputs(torch, g, m, k, n, dt)
        c0 = torch.zeros((m, n), dtype=out, device="cuda")
        st0 = acc_zero_state(torch, m, n, bm, bn)
        kw = dict(bm=bm, bn=bn, verify=True,
                  eps_c=ops.detection_eps(out))
        # a clean two-call chain on the kernel: the second call verifies the
        # state the first one wrote
        c1, ccol1, crow1, _ = kmm.abft_matmul_acc_cuda(a0, b0, c0, *st0, wm,
                                                       wn, **kw)
        want = kmm.abft_matmul_acc_plain(a, b, c1, ccol1, crow1, wm, wn, **kw)
        got = kmm.abft_matmul_acc_cuda(a, b, c1, ccol1, crow1, wm, wn, **kw)
        route = dict(kmm.last_acc_route)
        again = kmm.abft_matmul_acc_cuda(a, b, c1, ccol1, crow1, wm, wn, **kw)
        if in_place:
            # the SUMMA's call: C_out and the new state over the inputs,
            # bit for bit the out-of-place result
            ins = (c1.clone(), ccol1.clone(), crow1.clone())
            got = kmm.abft_matmul_acc_cuda(a, b, *ins, wm, wn, **kw, out=ins)
        torch.cuda.synchronize()
        want_route = kmm.route_of(bm, bn, carry=True)
        if route["route"] != want_route or tuple(route["tile"]) != (bm, bn):
            raise AssertionError(f"{(m, k, n, name)} ran {route}, planned "
                                 f"{want_route} on {(bm, bn)}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"two calls differ at {(m, k, n, name)}"
                                 + (" (in place)" if in_place else ""))
        stats = got[3]
        if float(stats[..., 4:6].abs().max()) != 0.0:
            raise AssertionError(f"clean chain re-verified with residual "
                                 f"{float(stats[..., 4:6].abs().max())} at "
                                 f"{(m, k, n, name)}: not exactly 0")
        if float(stats[..., :2].abs().max()) != 0.0 \
                or float(want[3][..., :2].abs().max()) != 0.0:
            raise AssertionError(f"clean chain flagged at {(m, k, n, name)}")
        if not torch.equal(stats[..., 2:4], want[3][..., 2:4]):
            raise AssertionError("stats sentinels differ from the plain "
                                 "version")
        cg, cp = got[0].double(), want[0].double()
        err = float((cg - cp).abs().max())
        if out == torch.int32:
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"int8 c not bit-exact at {(m, k, n)}")
        elif not within(cg, cp, float(cp.abs().max())):
            raise AssertionError(f"c differs at {(m, k, n, name)}: {err}")
        terms = float((wm.abs().double() @ cp.abs()).max())
        for x, y in zip(got[1:3], want[1:3]):
            if not within(x.double(), y.double(), terms):
                raise AssertionError(f"state differs at {(m, k, n, name)}: "
                                     f"{float((x - y).abs().max())}")
        lib = None
        if dt == torch.float32:
            lib = lambda: torch.addmm(c1, a, b)          # noqa: E731
        elif dt == torch.bfloat16:
            c1b = c1.to(dt)
            lib = lambda: torch.addmm(c1b, a, b)         # noqa: E731
        reps = 5 if m * n * k > 1e9 else 20
        if in_place:
            ms = time_ms(torch, lambda: kmm.abft_matmul_acc_cuda(
                a, b, *ins, wm, wn, **kw, out=ins), reps, flush)
        else:
            ms = time_ms(torch, lambda: kmm.abft_matmul_acc_cuda(
                a, b, c1, ccol1, crow1, wm, wn, **kw), reps, flush)
        plain_ms = time_ms(torch, lambda: kmm.abft_matmul_acc_plain(
            a, b, c1, ccol1, crow1, wm, wn, **kw), reps, flush)
        lib_ms = time_ms(torch, lib, reps, flush) if lib else None
        b_ms, b_by, b_cuda = acc_bound(m, k, n, 2, name, 4, bm, bn)
        row = dict(m=m, k=k, n=n, dtype=name, tile=[bm, bn],
                   route=route["route"], in_place=in_place,
                   copy_bytes=[route["copy_a"], route["copy_b"]],
                   repeat_bit_identical=True,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   bound_cuda_core_ms=b_cuda, clean_residual=0.0)
        rows.append(row)
        log("acc", json.dumps(row))
    record["acc_cases"] = rows
    record["acc_drills"] = _acc_drills(torch, g)
    return rows


def _acc_drills(torch, g):
    """The flip drills of the reference's kernel tests and chaos campaign,
    on the kernel, each held against the plain version."""
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.kernels import ops

    def chain(a, b, c, st, wm, wn, bm=128, bn=128, **kw):
        got = kmm.abft_matmul_acc_cuda(a, b, c, *st, wm, wn, bm=bm, bn=bn,
                                       **kw)
        want = kmm.abft_matmul_acc_plain(a, b, c, *st, wm, wn, bm=bm, bn=bn,
                                         **kw)
        torch.cuda.synchronize()
        if not torch.equal(got[3][..., :4], want[3][..., :4]):
            raise AssertionError("kernel and plain version disagree on "
                                 "detection or location")
        return got

    def setup(m, k, n, dt=torch.float32, lo=None):
        if lo is None:
            a = torch.randn((m, k), generator=g, device="cuda").to(dt)
            b = torch.randn((k, n), generator=g, device="cuda").to(dt)
        else:
            a = torch.randint(lo, -lo + 1, (m, k), generator=g, device="cuda",
                              dtype=dt)
            b = torch.randint(lo, -lo + 1, (k, n), generator=g, device="cuda",
                              dtype=dt)
        wm = ops.kernel_weights(m, device="cuda")
        wn = ops.kernel_weights(n, device="cuda").T.contiguous()
        out = torch.int32 if dt == torch.int8 else torch.float32
        c0 = torch.zeros((m, n), dtype=out, device="cuda")
        return a, b, wm, wn, c0, acc_zero_state(torch, m, n, 128, 128)

    drills = {}
    # five single flips at 384 x 256 x 512 (tests/test_kernels.py)
    a, b, wm, wn, c0, st0 = setup(384, 256, 512)
    clean, ccol1, crow1, _ = chain(a, b, c0, st0, wm, wn)
    za, zb = torch.zeros_like(a), torch.zeros_like(b)
    scale = float(clean.abs().max())
    for r, c, delta in [(0, 0, 1e4), (383, 511, -3e3), (200, 300, 1e6),
                        (130, 40, 2.5e3), (37, 201, 1e30)]:
        bad = clean.clone()
        bad[r, c] += delta
        fixed, _, _, stats = chain(za, zb, bad, (ccol1, crow1), wm, wn)
        got = (float(stats[..., 0].max()), float(stats[..., 1].max()),
               float(stats[..., 2].max()), float(stats[..., 3].max()))
        err = float((fixed - clean).abs().max())
        ok = ((fixed - clean).abs()
              <= 1e-5 * clean.abs() + 1e-4 * scale).all()
        if got != (1.0, 1.0, float(r), float(c)) or not bool(ok):
            raise AssertionError(f"flip {(r, c, delta)}: stats {got}, "
                                 f"max err {err}")
        drills[f"flip_{r}_{c}"] = err
        log("acc", f"flip {delta:g} at ({r},{c}): detected, located at "
                   f"({int(got[2])},{int(got[3])}), repaired, max |fixed - "
                   f"clean| = {err:.3g}")
    # verify off: no scrub, sentinel stats
    out, _, _, stats = chain(za, zb, bad, (ccol1, crow1), wm, wn,
                             verify=False)
    if float(stats[..., :2].abs().max()) != 0.0 \
            or float(stats[..., 2:4].max()) != -1.0 \
            or not torch.equal(out, bad):
        raise AssertionError("verify=False scrubbed or left no sentinels")
    # two flips in two tiles, both repaired
    a, b, wm, wn, c0, st0 = setup(256, 256, 256)
    clean, ccol1, crow1, _ = chain(a, b, c0, st0, wm, wn)
    bad = clean.clone()
    bad[10, 20] += 5e3
    bad[200, 200] -= 4e3
    fixed, _, _, stats = chain(torch.zeros_like(a), torch.zeros_like(b), bad,
                               (ccol1, crow1), wm, wn)
    locs = {(int(r), int(c)) for r, c in stats[..., 2:4].reshape(-1, 2)
            .tolist() if r >= 0}
    err = float((fixed - clean).abs().max())
    if float(stats[..., 1].sum()) != 2.0 or locs != {(10, 20), (200, 200)} \
            or err > 1e-3:
        raise AssertionError(f"two flips: located {locs}, max err {err}")
    drills["two_tiles"] = err
    log("acc", f"two flips in two tiles: both located {sorted(locs)} and "
               f"repaired, max err {err:.3g}")
    # an int8 data flip, repaired bit-exactly
    a1, b1, wm, wn, c0, st0 = setup(256, 256, 256, torch.int8, -4)
    a2, b2, *_ = setup(256, 256, 256, torch.int8, -4)
    c1, ccol1, crow1, _ = chain(a1, b1, c0, st0, wm, wn)
    c2, _, _, _ = chain(a2, b2, c1, (ccol1, crow1), wm, wn)
    bad = c1.clone()
    bad[7, 9] ^= 1 << 20
    c2f, _, _, stats = chain(a2, b2, bad, (ccol1, crow1), wm, wn)
    if not (bool(stats[..., 1].any()) and torch.equal(c2f, c2)):
        raise AssertionError("int8 data flip not repaired bit-exactly")
    drills["int8_data_flip"] = "repaired bit-exactly"
    log("acc", "int8 data flip (bit 20 of C[7, 9]): repaired bit-exactly")
    # a flip in the carried ccol: detected, not repaired, data untouched
    a1, b1, wm, wn, c0, st0 = setup(256, 256, 256)
    a2, b2, *_ = setup(256, 256, 256)
    c1, ccol1, crow1, _ = chain(a1, b1, c0, st0, wm, wn)
    c2, _, _, _ = chain(a2, b2, c1, (ccol1, crow1), wm, wn)
    ccol_bad = ccol1.clone()
    ccol_bad.view(torch.int32)[1, 0, 77] ^= 1 << 27
    c2f, _, _, stats = chain(a2, b2, c1, (ccol_bad, crow1), wm, wn)
    if not bool(stats[..., 0].any()) or bool(stats[..., 1].any()) \
            or not torch.equal(c2f, c2):
        raise AssertionError("carried-ccol flip: not detect-only")
    drills["ccol_flip"] = "detected, not repaired"
    log("acc", "carried-ccol flip (bit 27 of ccol[1, 0, 77]): detected, not "
               "repaired, data passed through bit-identical")
    return drills


SUMMA_G = 8          # the paper's smallest Table 2 grid: p = 64
SUMMA_NB = 3072      # its n_loc = 3000, rounded up to a multiple of 128


def phase_summa(torch, record, card):
    """abft_summa at the paper's size on the kernel; returns the kernel
    launches of the five ABFT runs (the main path)."""
    import repro_torch.core as core
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.launch import stress

    G, nb = SUMMA_G, SUMMA_NB
    pr = G - 1
    per_run = G ** 3
    g = torch.Generator(device="cuda").manual_seed(3)
    spec = core.make_spec(1, pr, pr, device="cuda")
    a = torch.randn((pr * nb, G * nb), generator=g, device="cuda")
    b = torch.randn((G * nb, pr * nb), generator=g, device="cuda")
    x = torch.randn((pr * nb,), generator=g, device="cuda")
    a_enc, b_enc = core.encode_operands(a, b, spec)
    runs = [
        ("clean", {}),
        ("failure (2,5) after step 3",
         dict(failure=core.FailureEvent(step=3, row=2, col=5))),
        ("double failure (0,1)+(6,4) after step 5",
         dict(failure=core.MultiFailureEvent(step=5,
                                             devices=((0, 1), (6, 4))))),
        ("flip 1e4 in block (1,3) after step 4",
         dict(bitflip=core.BitflipEvent(step=4, row=1, col=3, delta=1e4))),
        ("flip -3e3 in block (6,0) after step 8",
         dict(bitflip=core.BitflipEvent(step=8, row=6, col=0,
                                        delta=-3e3))),
    ]
    out = []
    torch.cuda.synchronize()
    kmm.reset_counts()                      # the main path starts here
    for name, kw in runs:
        l0, p0 = kmm.acc_launches, kmm.acc_plain_calls
        seen = []
        t0 = time.perf_counter()
        c_enc = core.abft_summa(
            a_enc, b_enc, G, spec=spec, local_update="auto",
            on_stats=lambda k, r, c, s: seen.append(((k, r, c), s)), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = kmm.acc_launches - l0, kmm.acc_plain_calls - p0
        resid = stress.residual_check(core.strip(c_enc, nb, nb), a, b, x)
        consistent = bool(core.verify(c_enc, spec).consistent)
        hits = {key: s for key, s in seen if bool(s[..., 0].any())}
        row = dict(run=name, wall_s=wall, launches=launches,
                   plain_calls=plain, residual=resid, consistent=consistent,
                   detected_launches=sorted(hits))
        log("summa", json.dumps(row))
        out.append(row)
        if launches != per_run or plain != 0:
            raise AssertionError(f"{name}: {launches} kernel launches, {plain}"
                                 f" plain calls (want {per_run}, 0)")
        if not resid < stress.THRESHOLD or not consistent:
            raise AssertionError(f"{name}: residual {resid}, consistent "
                                 f"{consistent}")
        if "bitflip" in kw and kw["bitflip"].step < G:
            want = (kw["bitflip"].step, kw["bitflip"].row, kw["bitflip"].col)
            s = hits.get(want)
            if list(hits) != [want] or s is None \
                    or s[0, 0, :4].tolist() != [1.0, 1.0, 0.0, 0.0] \
                    or int(s[..., 0].sum()) != 1:
                raise AssertionError(f"{name}: launches that detected "
                                     f"{sorted(hits)}; want only {want} with "
                                     "detected = corrected = 1 at (0, 0)")
        elif "failure" not in kw and hits:
            raise AssertionError(f"{name}: launches {sorted(hits)} detected "
                                 "a fault that was not there")
        del c_enc, seen, hits
    main_launches = kmm.acc_launches          # the main path ends here
    del a_enc, b_enc, a, b
    torch.cuda.empty_cache()

    # the paper's PBLAS comparison: plain SUMMA on the same grid and blocks,
    # G * nb of data against (G - 1) * nb under ABFT
    a = torch.randn((G * nb, G * nb), generator=g, device="cuda")
    b = torch.randn((G * nb, G * nb), generator=g, device="cuda")
    x = torch.randn((G * nb,), generator=g, device="cuda")
    for lu in ("auto", "torch"):
        l0 = kmm.acc_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = core.summa(a, b, G, local_update=lu)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        resid = stress.residual_check(c, a, b, x)
        row = dict(run=f"plain summa, local_update={lu}", wall_s=wall,
                   launches=kmm.acc_launches - l0, residual=resid)
        log("summa", json.dumps(row))
        out.append(row)
        if not resid < stress.THRESHOLD:
            raise AssertionError(f"plain summa ({lu}): residual {resid}")
        del c
    del a, b
    torch.cuda.empty_cache()

    l0, p0 = kmm.acc_launches, kmm.acc_plain_calls
    res = stress.run(grid=4, block=512, iters=8, device="cuda",
                     verbose=False)
    launches = kmm.acc_launches - l0
    log("summa", f"stress CLI, G = 4, NB = 512, 8 iterations: "
                 f"{res['failures']} process kills, {res['flips']} flips, "
                 f"max residual {max(res['residuals']):.4g}, {launches} "
                 f"kernel launches")
    if launches != 8 * 4 ** 3 or kmm.acc_plain_calls != p0:
        raise AssertionError(f"stress: {launches} kernel launches")
    record["summa"] = dict(runs=out, grid=G, nb=nb, card=card,
                           stress=res, main_path_launches=main_launches)
    return main_launches


# ---------------------------------------------------------------------------
# phases 8 and 9: the diskless encode kernel and fault-tolerant training
# ---------------------------------------------------------------------------

ENC_CASES = [        # (what, p, f, m, n, dtype): views the encode takes
    ("embedding view, bf16 params", 4, 1, 37984, 896, "bfloat16"),
    ("embedding view, fp32 moments", 4, 1, 37984, 896, "float32"),
    ("mlp.gate.w group view [4, 6, 896 x 4864]", 4, 1, 6, 896 * 4864,
     "bfloat16"),
    ("final_norm view [4, 224]", 4, 1, 1, 224, "bfloat16"),
    ("ragged, p = 16, f = 3", 16, 3, 1000, 999, "float32"),
    # p = 1: the views of stack_view(state, 1), which ElasticRuntime at
    # 1 x 1 encodes and verifies (phases 11 and 13); the checksum row is
    # all ones, so the output is the state itself, bit for bit
    ("p = 1 embedding view [1, 151936, 896], fp32", 1, 1, 151936, 896,
     "float32"),
    ("p = 1 embedding view, bf16", 1, 1, 151936, 896, "bfloat16"),
    ("p = 1 mlp.gate.w group view [1, 24, 896 x 4864], fp32", 1, 1, 24,
     896 * 4864, "float32"),
    ("p = 1 final_norm view [1, 1, 896], fp32", 1, 1, 1, 896, "float32"),
]


def enc_bound(p, f, m, n, itemsize):
    """Least time of one encode: X read once, Y written once, A read once,
    over HBM; 2 f p m n operations at the fp32 CUDA-core rate (the sums are
    fp32 whatever the storage type)."""
    nbytes = (p + f) * m * n * itemsize + f * p * 4
    ops = 2 * f * p * m * n
    t_bytes, t_ops = nbytes / H100_HBM_BPS, ops / CUDA_CORE_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def enc_times(torch, x, a, flush, reps):
    """(kernel, plain, torch.matmul) ms of one encode of the [p, m, n]
    view x; the library call is the same function as one product of A by
    X viewed as [p, m n], in X's type."""
    from repro_torch.kernels import checksum_encode as kenc

    a_x, xv = a.to(x.dtype), x.reshape(x.shape[0], -1)
    return (time_ms(torch, lambda: kenc.checksum_encode_cuda(x, a), reps,
                    flush),
            time_ms(torch, lambda: kenc.checksum_encode_plain(x, a), reps,
                    flush),
            time_ms(torch, lambda: torch.matmul(a_x, xv), reps, flush))


def phase_encode(torch, record):
    """Kernel #3 against its plain version at the views of the full-width
    train state and one ragged case, with its times."""
    from repro_torch.core.checksum import checkpoint_matrix
    from repro_torch.kernels import checksum_encode as kenc

    g = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for what, p, f, m, n, name in ENC_CASES:
        dt = getattr(torch, name)
        x = torch.randn((p, m, n), generator=g, device="cuda").to(dt)
        a = checkpoint_matrix(f, p, device="cuda")
        got = kenc.checksum_encode_cuda(x, a)
        want = kenc.checksum_encode_plain(x, a)
        torch.cuda.synchronize()
        # any order of the p fp32 sums lies within p eps32 of the sum of
        # the terms' magnitudes; a bf16 checksum may then round one bf16 ulp
        # (at most 2^-7 of its value) apart
        terms = torch.matmul(a.abs(), x.reshape(p, -1).float().abs()) \
            .reshape(want.shape)
        tol = 4 * p * 2.0 ** -24 * terms
        if dt == torch.bfloat16:
            tol = tol + 2.0 ** -7 * want.float().abs()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if not bool((diff <= tol).all()):
            raise AssertionError(f"encode {what}: kernel and plain differ by "
                                 f"{err}, over the stated tolerance")
        if p == 1 and not (torch.equal(got, want) and torch.equal(got, x)):
            raise AssertionError(f"encode {what}: at p = 1 the kernel's "
                                 "output is not the state bit for bit")
        del got, want, terms, tol, diff
        ms, plain_ms, lib_ms = enc_times(torch, x, a, flush, 10)
        b_ms, b_by = enc_bound(p, f, m, n, x.element_size())
        row = dict(case=what, p=p, f=f, m=m, n=n, dtype=name,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   gbps=(p + f) * m * n * x.element_size() / ms / 1e6)
        rows.append(row)
        log("encode", json.dumps(row))
        del x
    torch.cuda.empty_cache()
    record["encode_cases"] = rows
    return rows


TRAIN_STEPS = 30
REPLAY_RTOL = 1e-3


def _bits(torch, x):
    """x's raw bits, for a bit-for-bit comparison."""
    if x.is_floating_point():
        return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])
    return x


def _recovery_errors(torch, dc, snap, k):
    """Recover shard k of the held checkpoint and measure each encoded
    leaf's error against the snapshot: survivors must come back bit for
    bit, and the lost shard within the bound of its arithmetic — a bf16
    checksum is rounded to bf16 (half an ulp of y), the fp32 solve adds a
    few fp32 ulps of the terms, and the result is rounded to the leaf's
    type (half an ulp of it)."""
    from repro_torch.tree import keystr, tree_leaves, tree_leaves_with_path

    rec = dc.recover(snap, [k])
    p = dc.p
    worst = {"bfloat16": [0.0, 0.0, ""], "float32": [0.0, 0.0, ""]}
    for (path, r), s, y in zip(tree_leaves_with_path(rec), tree_leaves(snap),
                               tree_leaves(dc._enc)):
        if not (s.is_floating_point() and s.dim() >= 1 and s.shape[0] == p):
            continue
        others = [i for i in range(p) if i != k]
        if not torch.equal(_bits(torch, r[others]), _bits(torch, s[others])):
            raise AssertionError(f"{keystr(path)}: a surviving shard did not "
                                 "roll back bit for bit")
        x, xr, y0 = s[k].float(), r[k].float(), y[0].float()
        err = (xr - x).abs()
        terms = s.float().abs().sum(0) + y0.abs()
        bound = 8 * p * 2.0 ** -24 * terms
        name = str(s.dtype).replace("torch.", "")
        if name == "bfloat16":
            def ulp(v):
                return torch.exp2(torch.floor(torch.log2(
                    v.abs().clamp_min(2.0 ** -126))) - 7)
            bound = bound + 0.5 * ulp(y0) + 0.5 * ulp(torch.maximum(
                x.abs(), xr.abs()))
        if not bool((err <= bound).all()):
            raise AssertionError(f"{keystr(path)}: recovered shard {k} off by "
                                 f"{float(err.max())}, over its bound")
        e, rel = float(err.max()), float(err.max() / (x.abs().max() + 1e-30))
        if e > worst[name][0]:
            worst[name] = [e, rel, keystr(path)]
        del x, xr, y0, err, terms, bound
    return rec, worst


def phase_train(torch, record, card):
    """repro_torch.launch.train.run at full width: the main path of this
    slice; returns (kernel #3 launches, one-encode times) of it."""
    from repro_torch.ckpt.disk import CheckpointManager
    from repro_torch.ckpt.diskless import DisklessCheckpoint, encode_view
    from repro_torch.configs.base import get_config
    from repro_torch.ft.runtime import stack_view, unstack_view
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.kernels import checksum_encode as kenc
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(smoke=False, batch=16, seq=128, abft_mode="verify",
              diskless_every=5, ckpt_dir=str(ckpt), log_every=5,
              device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kmm.reset_counts()
    kenc.reset_counts()                      # the main path starts here
    t0 = time.perf_counter()
    res = train.run("qwen2-0.5b", steps=TRAIN_STEPS, inject_failures=2, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    l1, p1 = kmm.launches, kmm.plain_calls
    l3, p3 = kenc.launches, kenc.plain_calls  # the main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ft, dc = res.ft, res.ft.diskless
    n_float = sum(1 for x in tree_leaves(dc._snapshot)
                  if x.is_floating_point())
    encodes = len(ft.timings["encode"])
    passes = 2 * len(res.losses)      # remat runs every block again
    per_pass = 7 * get_config("qwen2-0.5b").n_layers    # 168 projections
    log("train", f"{len(res.losses)} steps run ({TRAIN_STEPS} + replays), "
                 f"{encodes} encodes x {n_float} floating leaves = {l3} "
                 f"kernel #3 launches, {per_pass} x {passes} forward passes = "
                 f"{l1} "
                 f"kernel #1 launches, plain calls {p3} / {p1}, "
                 f"recoveries {ft.recoveries}")
    if l3 != encodes * n_float or p3 != 0:
        raise AssertionError(f"kernel #3: {l3} launches, {p3} plain calls "
                             f"(want {encodes} x {n_float}, 0)")
    if l1 != per_pass * passes or p1 != 0:
        raise AssertionError(f"kernel #1: {l1} launches, {p1} plain calls "
                             f"(want {per_pass} x {passes}, 0)")
    if ft.recoveries["diskless"] != 2:
        raise AssertionError(f"recoveries {ft.recoveries}: want 2 diskless")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"non-finite loss: {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"loss did not fall: {res.losses[0]} -> "
                             f"{res.losses[-1]}")
    first, replays = {}, []
    for s, v in zip(res.steps, res.losses):
        if s in first:
            replays.append(dict(step=s, first=first[s], replay=v,
                                rel=abs(v - first[s]) / abs(first[s])))
        else:
            first[s] = v
    if not replays or any(r["rel"] > REPLAY_RTOL for r in replays):
        raise AssertionError(f"replayed steps against their first pass: "
                             f"{replays} (tolerance {REPLAY_RTOL})")
    log("train", f"replayed steps {[r['step'] for r in replays]}: max "
                 f"|loss - first pass| / loss = "
                 f"{max(r['rel'] for r in replays):.3g} (tolerance "
                 f"{REPLAY_RTOL}); loss {res.losses[0]:.4f} -> "
                 f"{res.losses[-1]:.4f}")
    steady = sorted(res.step_walls[1:])
    walls = dict(first_step_s=res.step_walls[0],
                 median_step_s=steady[len(steady) // 2],
                 encode_s=ft.timings["encode"], recover_s=ft.timings["recover"],
                 save_host_copy_s=ft.timings["save"], run_s=wall,
                 peak_gb=peak_gb)
    log("train", "walls " + json.dumps(walls))

    # the held checkpoint: verify, a flip, the recovery error, reshard
    snap = dc.snapshot()
    ok, bad, worst = dc.verify(snap)
    if not ok or worst != 0.0:
        raise AssertionError(f"verify of the held snapshot: {ok} {bad} "
                             f"{worst}")
    table = snap["params"]["embed"]["table"]
    old = table[1, 2, 3].clone()
    table[1, 2, 3] += 1e4
    ok_f, bad_f, worst_f = dc.verify(snap)
    table[1, 2, 3] = old
    if ok_f or bad_f != "['params']['embed']['table']":
        raise AssertionError(f"a 1e4 flip was not caught: {ok_f} {bad_f}")
    log("train", f"verify of the held snapshot (step {dc.step}): residual "
                 f"{worst}; a 1e4 flip in {bad_f}: residual {worst_f:.4g}, "
                 "tripped")
    rec, rec_err = _recovery_errors(torch, dc, snap, 1)
    log("train", f"shard 1 recovered from the held checkpoint: survivors bit "
                 f"for bit; max error bf16 {rec_err['bfloat16']}, fp32 "
                 f"{rec_err['float32']} (abs, relative to max |leaf|, leaf)")
    dc2 = dc.reshard(2, failed=[1])
    want = stack_view(unstack_view(rec, res.state), 2)
    del rec, snap
    fresh = DisklessCheckpoint(2, dc.f)
    fresh.encode(want, dc.step, owned=True)
    for (path, a), b in zip(tree_leaves_with_path(dc2._snapshot),
                            tree_leaves(fresh._snapshot)):
        if not torch.equal(_bits(torch, a), _bits(torch, b)):
            raise AssertionError(f"reshard snapshot differs at {path}")
    for (path, a), b in zip(tree_leaves_with_path(dc2._enc),
                            tree_leaves(fresh._enc)):
        if not torch.equal(_bits(torch, a), _bits(torch, b)):
            raise AssertionError(f"reshard checksums differ at {path}")
    ok2, _, worst2 = dc2.verify(dc2.snapshot())
    if not ok2 or worst2 != 0.0:
        raise AssertionError("the re-keyed checkpoint does not verify")
    log("train", "reshard(2, failed=[1]): snapshot and checksums bit for bit "
                 "those of a fresh encode of the recovered state re-split "
                 "over 2 shards; verifies at residual 0")
    del dc2, fresh, want
    torch.cuda.empty_cache()

    # one diskless encode of the whole state, leaf by leaf, on its own data
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    a = dc._matrix(dc._snapshot["params"]["embed"]["table"].device)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               gbytes=0.0, bound_by="bytes")
    for x in tree_leaves(dc._snapshot):
        if not x.is_floating_point():
            continue
        v = encode_view(x, dc.p)
        ms, plain_ms, lib_ms = enc_times(torch, v, a, flush, 5)
        p_, m_, n_ = v.shape
        b_ms, b_by = enc_bound(p_, dc.f, m_, n_, x.element_size())
        if b_by != "bytes":
            tot["bound_by"] = "bytes and operations"
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", b_ms)):
            tot[key] += val
        tot["gbytes"] += (p_ + dc.f) * m_ * n_ * x.element_size() / 1e9
    log("train", f"one encode of the full-width state ({n_float} leaves, "
                 f"{tot['gbytes']:.3f} GB moved), summed over its launches: "
                 f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
                 f"torch.matmul {tot['library_ms']:.3f} ms, bound "
                 f"{tot['bound_ms']:.3f} ms")

    # resume from the disk checkpoint of the last step
    mgr = CheckpointManager(ckpt)
    t0 = time.perf_counter()
    restored = mgr.restore(TRAIN_STEPS, res.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for a_, b_ in zip(tree_leaves(restored), tree_leaves(res.state)):
        if a_.dtype != b_.dtype or not torch.equal(_bits(torch, a_),
                                                   _bits(torch, b_)):
            raise AssertionError("the disk checkpoint did not restore the "
                                 "state bit for bit")
    del restored
    final = res.losses[-1]
    del res, ft, dc
    torch.cuda.empty_cache()
    res2 = train.run("qwen2-0.5b", steps=TRAIN_STEPS + 3, resume=True,
                     total_steps=TRAIN_STEPS, **kw)
    if res2.resumed_from != TRAIN_STEPS \
            or res2.steps != list(range(TRAIN_STEPS, TRAIN_STEPS + 3)) \
            or not all(math.isfinite(v) for v in res2.losses):
        raise AssertionError(f"resume: from {res2.resumed_from}, steps "
                             f"{res2.steps}, losses {res2.losses}")
    log("train", f"disk checkpoint of step {TRAIN_STEPS} restored bit for "
                 f"bit in {restore_s:.2f} s; --resume ran steps "
                 f"{res2.steps} (loss {final:.4f} -> {res2.losses[-1]:.4f})")
    del res2
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    record["train"] = dict(
        steps=TRAIN_STEPS, launches_encode=l3, launches_matmul=l1,
        encodes=encodes, float_leaves=n_float, forward_passes=passes,
        recoveries=2, replays=replays, walls=walls,
        recovery_error=rec_err, full_encode=tot, restore_s=restore_s,
        card=card)
    return l3, tot


# (what, BH, Sq, Sk, D, dtype, causal, window, softcap, checksum, bq = bk);
# BH is batch x query heads
FLASH_CASES = [
    ("qwen2-0.5b", 56, 4096, 4096, 64, "float32", True, None, None, False,
     256),
    ("qwen2-0.5b", 56, 4096, 4096, 64, "float32", True, None, None, True,
     256),
    ("qwen2-0.5b", 56, 4096, 4096, 64, "bfloat16", True, None, None, False,
     256),
    ("qwen2-0.5b", 56, 4096, 4096, 64, "bfloat16", True, None, None, True,
     256),
    ("gemma2-2b local", 16, 8192, 8192, 256, "bfloat16", True, 4096, 50.0,
     True, 256),
    ("rectangular", 56, 256, 1024, 64, "float32", False, None, None, True,
     256),
    # the chaos campaign's flash drill
    ("campaign drill", 2, 512, 512, 64, "float32", True, None, None, False,
     128),
    ("campaign drill", 2, 512, 512, 64, "float32", True, None, None, True,
     128),
    # B.H past grid.y's 65535, which the reference does not bound
    ("B.H 65540", 65540, 64, 64, 64, "float32", True, None, None, False, 64),
    ("B.H 65540", 65540, 64, 64, 64, "float32", True, None, None, True, 64),
]
FLASH_BLOCK = 256
BF16_ULP = 2.0 ** -7          # one bf16 ulp, relative


def flash_pairs(sq, sk, causal, window):
    """(q, k) pairs the mask admits in one [sq, sk] head."""
    n = 0
    for r in range(sq):
        lo, hi = 0, sk
        if causal:
            hi = min(hi, r + 1)
        if window is not None:
            lo = max(lo, r - window + 1)
            hi = min(hi, r + window)
        n += max(0, hi - lo)
    return n


def flash_bound(bh, sq, sk, d, dtype, causal, window, checksum):
    """Least time of one forward: Q, K, V read once and O written once
    over HBM; 4 D operations per admitted (q, k) pair (q.k and p.v; 3 more
    for the checksum's cs and l2, whatever the kernel's split costs) over
    the tensor-core rate of the operand type (fp32 through 3xTF32).
    Returns (ms, "bytes" or "operations", ms with fp32 operations at the
    CUDA-core rate instead), as ``bound`` does for kernel #1."""
    item = 4 if dtype == "float32" else 2
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * item
    ops = bh * flash_pairs(sq, sk, causal, window) * (4 * d + 3 * checksum)
    t_bytes, t_ops = nbytes / H100_HBM_BPS, ops / PEAK_OPS[dtype]
    t_cuda = ops / CUDA_CORE_FP32 if dtype == "float32" else t_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), \
        1e3 * max(t_bytes, t_cuda)


def flash_close(torch, x, ref, dtype):
    """fp32 within RTOL (relative, plus RTOL of the largest |ref|); bf16
    within one bf16 ulp of ref on top of that."""
    x, ref = x.double(), ref.double()
    rel = RTOL if dtype == "float32" else BF16_ULP
    scale = float(ref.abs().max())
    return bool(((x - ref).abs() <= rel * ref.abs() + RTOL * scale).all())


def phase_flash(torch, record):
    """Kernel #4 against its plain version at full width, timed, and its
    checked variant's drills at the Qwen2-0.5B shape."""
    import torch.nn.functional as tnf
    from repro_torch.kernels import flash_attention as kfa

    g = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for what, bh, sq, sk, d, name, causal, window, softcap, checksum, blk \
            in FLASH_CASES:
        dt = getattr(torch, name)
        q, k, v = (torch.randn((bh, n, d), generator=g, device="cuda")
                   .to(dt) for n in (sq, sk, sk))
        kw = dict(scale=d ** -0.5, causal=causal, window=window,
                  softcap=softcap, bq=blk, bk=blk, checksum=checksum)
        got = kfa.flash_attention_cuda(q, k, v, **kw)
        route = dict(kfa.last_route)
        want = kfa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if route["route"] != "mma" or route["tile"] != kfa.tile_of(d, dt):
            raise AssertionError(f"flash at {what} {name} ran {route}, not "
                                 f"the tensor-core tile {kfa.tile_of(d, dt)}")
        o, po = (got, want) if not checksum else (got[0], want[0])
        err = float((o.double() - po.double()).abs().max())
        if not (torch.isfinite(o).all() and flash_close(torch, o, po, name)):
            raise AssertionError(f"flash differs at {what} {name} "
                                 f"checksum={checksum}: {err}")
        resid = None
        if checksum:
            resid = float(got[1].max())
            if not resid <= kfa.FLASH_CHECK_TOL \
                    or not float(want[1].max()) <= kfa.FLASH_CHECK_TOL:
                raise AssertionError(f"clean checked run flagged at {what}: "
                                     f"{resid} / {float(want[1].max())}")
        reps = 5
        ms = time_ms(torch, lambda: kfa.flash_attention_cuda(q, k, v, **kw),
                     reps, flush)
        plain_ms = time_ms(
            torch, lambda: kfa.flash_attention_plain(q, k, v, **kw), 2,
            flush)
        lib_ms = q4 = k4 = v4 = None
        if causal and window is None and not softcap and sq == sk:
            # SDPA in the same dtype on [B, H, S, D]: its fused kernels
            # (flash for bf16, memory-efficient for fp32) take 4-D inputs
            # (3-D ones fall back to its unfused math path) and put the
            # heads in grid.y, so H stays under 65,536
            b = next(b for b in range(1, bh + 1)
                     if bh % b == 0 and bh // b < 65536)
            q4, k4, v4 = (x.view(b, bh // b, -1, d) for x in (q, k, v))
            lib_ms = time_ms(torch, lambda: tnf.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, scale=d ** -0.5), reps, flush)
        b_ms, b_by, b_cuda = flash_bound(bh, sq, sk, d, name, causal, window,
                                         checksum)
        row = dict(what=what, bh=bh, sq=sq, sk=sk, d=d, dtype=name,
                   causal=causal, window=window, softcap=softcap,
                   checksum=checksum, block=blk, route=route["route"],
                   tile=list(route["tile"]),
                   copy=[route["copy_q"], route["copy_k"], route["copy_v"]],
                   max_abs_err=err, clean_residual=resid,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, cuda_core_bound_ms=b_cuda)
        rows.append(row)
        log("flash", json.dumps(row))
        del q, k, v, got, want, o, po, q4, k4, v4
        torch.cuda.empty_cache()
    record["flash_cases"] = rows
    record["flash_widths"] = _flash_widths(torch, g, kfa)
    record["flash_drills"] = _flash_drills(torch, g, kfa)
    return rows


def _flash_widths(torch, g, kfa):
    """Every tile the kernel builds (each head width in fp32 and bf16) at
    [2, 512, D], causal with a window of 100 and a softcap of 30, checked:
    the tensor-core route on its planned tile, the output within
    flash_close of the plain version, clean residuals under the check's
    tolerance."""
    out = []
    for d in kfa.HEAD_DIMS:
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)
            q, k, v = (torch.randn((2, 512, d), generator=g, device="cuda")
                       .to(dt) for _ in range(3))
            kw = dict(scale=d ** -0.5, causal=True, window=100, softcap=30.0,
                      bq=128, bk=128, checksum=True)
            o, st = kfa.flash_attention_cuda(q, k, v, **kw)
            route = dict(kfa.last_route)
            po, _ = kfa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            if route["route"] != "mma" or \
                    route["tile"] != kfa.tile_of(d, dt) or \
                    not flash_close(torch, o, po, name) or \
                    not float(st.max()) <= kfa.FLASH_CHECK_TOL:
                raise AssertionError(f"flash D={d} {name}: {route}, max "
                                     f"|o - plain| "
                                     f"{float((o.double() - po.double()).abs().max())}, "
                                     f"residual {float(st.max())}")
            out.append(dict(d=d, dtype=name, tile=list(route["tile"]),
                            max_abs_err=float((o.double() - po.double())
                                              .abs().max())))
    log("flash", "every tile (D " + ", ".join(map(str, kfa.HEAD_DIMS))
        + "; fp32 and bf16) on the tensor-core route, within flash_close "
          "of the plain version, clean residuals: "
        + "; ".join(f"{r['d']} {r['dtype']} {r['tile'][0]}x{r['tile'][1]}"
                    for r in out))
    return out


def _flash_drills(torch, g, kfa):
    """Injects into acc and l of q-tile 8 at a KV chunk before, on and past
    the diagonal, a NaN into acc, and a NaN and a -1e4 into l, at the
    Qwen2-0.5B shape: each flagged at exactly (0, 8) and repaired to within
    1e-5 of the clean output."""
    q, k, v = (torch.randn((56, 4096, 64), generator=g, device="cuda")
               for _ in range(3))
    kw = dict(scale=0.125, causal=True, bq=FLASH_BLOCK, bk=FLASH_BLOCK)
    clean = kfa.flash_attention_cuda(q, k, v, **kw)
    o, rep = kfa.flash_attention_checked(q, k, v, **kw)
    if not rep.ok or not torch.equal(o, clean):
        raise AssertionError(f"clean checked run: {rep}")
    drills = []
    for target, kk, delta in (("acc", 3, 1e4), ("acc", 8, 1e4),
                              ("acc", 12, 1e4), ("l", 3, 1e4),
                              ("l", 8, 1e4), ("l", 12, 1e4),
                              ("acc", 5, float("nan")),
                              ("l", 5, float("nan")), ("l", 5, -1e4)):
        inject = (8, kk, delta, target)
        o, rep = kfa.flash_attention_checked(q, k, v, inject=inject, **kw)
        err = float((o - clean).abs().max())
        if rep.detected != ((0, 8),) or rep.repaired != 1 or not err <= 1e-5:
            raise AssertionError(f"inject {target} kk={kk} {delta}: {rep}, "
                                 f"max |o - clean| {err}")
        if target == "l" and not delta > 0:
            # an l fault that leaves l NaN or negative: the plain version
            # flags the same tile (the reference flags none)
            _, pst = kfa.flash_attention_plain(q, k, v, checksum=True,
                                               inject=inject, **kw)
            flagged = torch.nonzero(~(pst <= kfa.FLASH_CHECK_TOL).all(-1))
            if flagged.tolist() != [[0, 8]]:
                raise AssertionError(f"plain version flags {flagged.tolist()}"
                                     f" for inject l kk={kk} {delta}")
        drills.append(dict(target=target, kk=kk, delta=str(delta),
                           r_pv=rep.max_pv_residual,
                           r_l=rep.max_rowsum_residual, repair_err=err))
    log("flash", f"clean checked run flags nothing; {len(drills)} injects "
                 "(acc and l at kk 3, 8, 12 of q-tile 8, a NaN into acc, a "
                 "NaN and -1e4 into l, those two on the plain version too) "
                 "each flagged at exactly (0, 8) and repaired to max |o - "
                 f"clean| <= {max(d['repair_err'] for d in drills):.3g}")
    return drills


# the campaign's kernel and layer rows: name -> (outcome, rung, end_state;
# None = within the promise)
CHAOS_ROWS = {
    "train:checksum_state_flip:s1": ("detected", None, "bit_identical"),
    "train:checksum_state_flip:s1:bf16:seed1":
        ("detected", None, "bit_identical"),
    "train:checksum_state_flip:s2:b29:int8:seed2":
        ("detected", None, "bit_identical"),
    "train:sdc_collective:s1:b20:int8":
        ("corrected", "kernel:masked_recompute", "bit_identical"),
    "train:sdc_collective:s2:bf16:seed2":
        ("corrected", "kernel:masked_recompute", None),
    "train:sdc_collective:s2:b28:seed3":
        ("corrected", "kernel:masked_recompute", None),
    "train:flash_state_flip:s1": ("corrected", "flash:recompute_tile", None),
    "train:flash_state_flip:s2:l:seed1":
        ("corrected", "flash:recompute_tile", None),
    "train:norm_corruption:s2": ("corrected", "recompute", "bit_identical"),
    "train:gather_corruption:s2": ("corrected", "recompute", "bit_identical"),
}


def _campaign_pairs(torch):
    """Kernels #4 and #2 against their plain versions on the campaign's own
    drills: each flash, carried-state and carried-data spec of the default
    space replayed with its inputs, plan, blocks and fault, every call made
    on the kernel and on the plain version.  Flash: outputs within RTOL,
    the same tiles flagged.  Accumulate: detection and location equal,
    clean calls' data and state within RTOL, the faulted call's data within
    the flip drills' tolerance (integers exactly)."""
    import numpy as np
    from repro_torch.chaos.campaign import CampaignRunner
    from repro_torch.chaos.faults import FaultSpace, flip_bit
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops

    def flags(stats):
        return ~(stats <= kfa.FLASH_CHECK_TOL)          # NaN flags

    def flash_pair(spec, rng):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 512, 64))
                                    .astype(np.float32)).cuda()
                   for _ in range(3))
        kw = dict(scale=64 ** -0.5, causal=True, bq=128, bk=128,
                  checksum=True)
        target = "l" if spec.variant == "l" else "acc"
        err = 0.0
        for inject in (None, (1, spec.step, spec.delta, target)):
            o, st = kfa.flash_attention_cuda(q, k, v, inject=inject, **kw)
            po, pst = kfa.flash_attention_plain(q, k, v, inject=inject, **kw)
            torch.cuda.synchronize()
            if not flash_close(torch, o, po, "float32") \
                    or not torch.equal(flags(st), flags(pst)) \
                    or bool(flags(st).any()) != (inject is not None):
                raise AssertionError(f"{spec.name} inject {inject}: kernel "
                                     f"and plain disagree")
            err = max(err, float((o.double() - po.double()).abs().max()))
        return err

    def acc_pair(spec, rng, runner):
        m = k = n = 256
        plan = CampaignRunner._acc_plan(m, k, n)
        a1, a2, b1, b2, c0, out_dt, _ = runner._kernel_drill_operands(
            spec, rng, m, k, n)
        wm = ops.kernel_weights(m, device="cuda")
        wn = ops.kernel_weights(n, device="cuda").T.contiguous()
        kw = dict(bm=plan.bm, bn=plan.bn, bk=plan.bk, out_dtype=out_dt,
                  eps_c=ops.detection_eps(c0.dtype))
        errs = []

        def pair(a, b, c, ccol, crow, fault):
            got = kmm.abft_matmul_acc_cuda(a, b, c, ccol, crow, wm, wn, **kw)
            want = kmm.abft_matmul_acc_plain(a, b, c, ccol, crow, wm, wn,
                                             **kw)
            torch.cuda.synchronize()
            if not torch.equal(got[3][..., :4], want[3][..., :4]) \
                    or bool(got[3][..., 0].any()) != fault:
                raise AssertionError(f"{spec.name}: detection or location "
                                     "differs from the plain version")
            cg, cp = got[0].double(), want[0].double()
            scale = float(cp.abs().max())
            if out_dt == torch.int32:
                ok = torch.equal(got[0], want[0])
            elif fault:
                ok = bool(((cg - cp).abs()
                           <= 1e-5 * cp.abs() + 1e-4 * scale).all())
            else:
                ok = within(cg, cp, scale)
            terms = float((wm.abs().double() @ cp.abs()).max())
            if not fault:
                ok = ok and all(within(x.double(), y.double(), terms)
                                for x, y in zip(got[1:3], want[1:3]))
            if not ok:
                raise AssertionError(f"{spec.name}: kernel and plain differ "
                                     f"(fault={fault})")
            errs.append(float((cg - cp).abs().max()))
            return got

        c1, ccol1, crow1, _ = pair(a1, b1, c0,
                                   *acc_zero_state(torch, m, n, plan.bm,
                                                   plan.bn), False)
        pair(a2, b2, c1, ccol1, crow1, False)
        if spec.kind == "checksum_state_flip":
            flat = int(np.ravel_multi_index((0, 0, int(rng.randint(n))),
                                            tuple(ccol1.shape)))
            pair(a2, b2, c1, flip_bit(ccol1, flat, bit=spec.bit), crow1,
                 True)
        else:
            flat = int(rng.randint(m)) * n + int(rng.randint(n))
            pair(a2, b2, flip_bit(c1, flat, bit=spec.bit), ccol1, crow1,
                 True)
        return max(errs), (plan.bm, plan.bn)

    runner = CampaignRunner(FaultSpace("pairs", ()), device="cuda")
    out = {}
    for spec in FaultSpace.default():
        if spec.workload != "train":
            continue
        rng = np.random.RandomState(spec.seed)
        if spec.kind == "flash_state_flip":
            out[spec.name] = dict(max_abs_err=flash_pair(spec, rng))
        elif spec.surface == "kernels.ops/acc_state":
            err, tile = acc_pair(spec, rng, runner)
            out[spec.name] = dict(max_abs_err=err, tile=list(tile))
    if len(out) != 8:
        raise AssertionError(f"campaign drills replayed: {sorted(out)}")
    log("chaos", f"kernels #4 and #2 held to their plain versions on the "
                 f"campaign's {len(out)} kernel drills (inputs, tiles and "
                 f"faults of each spec): max |kernel - plain| "
                 f"{max(r['max_abs_err'] for r in out.values()):.3g}")
    return out


# every row of the reference's campaign over the default space's train,
# serve and solver workloads on 8 devices (pod mesh 2 x 2 x 2, serve mesh
# 4 x 2), in its order: CAMPAIGN_PR7.json's 98 rows, with the five
# dtype-variant kernel rows the space has gained since at the reference's
# one-device values (they run no mesh): name, outcome, rung, end state
# (None = within the promise, for the kernel drills whose float repair may
# land bit-identical on the card)
CAMPAIGN_ROWS = [
    ('train:sdc_collective:s2', 'corrected', 'abft_inflight', 'within_tol'),
    ('train:checksum_state_flip:s1', 'detected', None, 'bit_identical'),
    ('train:checksum_state_flip:s1:bf16:seed1',
     'detected', None, 'bit_identical'),
    ('train:sdc_collective:s1:b20:int8',
     'corrected', 'kernel:masked_recompute', 'bit_identical'),
    ('train:flash_state_flip:s1', 'corrected', 'flash:recompute_tile', None),
    ('train:norm_corruption:s2', 'corrected', 'recompute', 'bit_identical'),
    ('train:gather_corruption:s2', 'corrected', 'recompute', 'bit_identical'),
    ('train:dram_params:s2', 'corrected', 'scrub:diskless', 'bit_identical'),
    ('train:dram_opt_state:s2:b29',
     'corrected', 'scrub:diskless', 'bit_identical'),
    ('train:shard_loss:s3', 'corrected', 'diskless', 'within_tol'),
    ('serve:sdc_collective:s1', 'corrected', 'abft_inflight', 'bit_identical'),
    ('serve:dram_kv_cache:s2',
     'corrected', 'scrub:kv_repair', 'bit_identical'),
    ('solver:sdc_collective:s4:sh3',
     'corrected', 'solver:replica_repair', 'bit_identical'),
    ('solver:dram_params:s12',
     'corrected', 'solver:guard_restart', 'within_tol'),
    ('solver:shard_loss:s6:sh4',
     'corrected', 'solver:failover', 'bit_identical'),
    ('solver:pod_loss:s5:p1:paired',
     'corrected', 'solver:reweight', 'within_tol'),
    ('train:sdc_collective:s4:d-30000:seed1',
     'corrected', 'abft_inflight', 'within_tol'),
    ('serve:sdc_collective:s3:sh1:d-30000:seed1',
     'corrected', 'abft_inflight', 'bit_identical'),
    ('serve:dram_params:s0', 'corrected', 'scrub:restore', 'bit_identical'),
    ('train:flash_state_flip:s2:l:seed1',
     'corrected', 'flash:recompute_tile', None),
    ('train:checksum_state_flip:s2:b29:int8:seed2',
     'detected', None, 'bit_identical'),
    ('train:sdc_collective:s2:bf16:seed2',
     'corrected', 'kernel:masked_recompute', None),
    ('train:sdc_collective:s2:b28:seed3',
     'corrected', 'kernel:masked_recompute', None),
    ('train:shard_loss:s3:sh1:seed1', 'corrected', 'diskless', 'within_tol'),
    ('train:pod_loss:s3:diskless',
     'corrected', 'elastic:diskless', 'within_tol'),
    ('train:pod_loss:s3:disk:seed1',
     'corrected', 'elastic:disk', 'within_tol'),
    ('train:slow_pod:s1', 'corrected', 'demote:disk', 'within_tol'),
    ('solver:pod_loss:s5:p2', 'corrected', 'solver:failover', 'within_tol'),
    ('train:sdc+dram_burst::e0:sdc_collective',
     'corrected', 'abft_inflight', 'not_compared'),
    ('train:sdc+dram_burst::e1:dram_params',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('train:sdc+dram_burst::e2:dram_params',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('train:sdc+dram_burst::e3:dram_opt_state',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('episode:train:sdc+dram_burst',
     'corrected', 'abft_inflight+scrub:diskless', 'within_tol'),
    ('serve:sdc+kv_dram::e0:sdc_collective',
     'corrected', 'abft_inflight', 'not_compared'),
    ('serve:sdc+kv_dram::e1:dram_kv_cache',
     'corrected', 'scrub:kv_repair', 'not_compared'),
    ('serve:sdc+kv_dram::e2:dram_params',
     'corrected', 'scrub:restore', 'not_compared'),
    ('episode:serve:sdc+kv_dram',
     'corrected', 'abft_inflight+scrub:kv_repair+scrub:restore',
     'bit_identical'),
    ('solver:sdc_during_pod_loss::e0:pod_loss',
     'corrected', 'solver:reweight', 'not_compared'),
    ('solver:sdc_during_pod_loss::e1:sdc_collective',
     'corrected', 'solver:replica_repair', 'not_compared'),
    ('episode:solver:sdc_during_pod_loss',
     'corrected', 'solver:replica_repair+solver:reweight', 'within_tol'),
    ('train:poisson250::e0:shard_loss',
     'corrected', 'diskless', 'not_compared'),
    ('episode:train:poisson250', 'corrected', 'diskless', 'bit_identical'),
    ('serve:poisson250::e0:dram_kv_cache',
     'corrected', 'scrub:kv_repair', 'not_compared'),
    ('serve:poisson250::e1:sdc_collective',
     'corrected', 'abft_inflight', 'not_compared'),
    ('episode:serve:poisson250',
     'corrected', 'abft_inflight+scrub:kv_repair', 'bit_identical'),
    ('solver:poisson150::e0:sdc_collective',
     'corrected', 'solver:replica_repair', 'not_compared'),
    ('solver:poisson150::e1:shard_loss',
     'corrected', 'solver:failover', 'not_compared'),
    ('solver:poisson150::e2:pod_loss',
     'corrected', 'solver:reweight', 'not_compared'),
    ('episode:solver:poisson150',
     'corrected', 'solver:failover+solver:replica_repair+solver:reweight',
     'within_tol'),
    ('train:dram+podloss::e0:dram_params', 'absorbed', None, 'not_compared'),
    ('train:dram+podloss::e1:pod_loss',
     'corrected', 'elastic:diskless', 'not_compared'),
    ('train:dram+podloss::e2:dram_params',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('episode:train:dram+podloss',
     'corrected', 'elastic:diskless+scrub:diskless', 'within_tol'),
    ('train:pod_repeat::e0:pod_loss',
     'corrected', 'elastic:diskless', 'not_compared'),
    ('train:pod_repeat::e1:pod_loss',
     'corrected', 'elastic:diskless', 'not_compared'),
    ('episode:train:pod_repeat',
     'corrected', 'elastic:diskless', 'within_tol'),
    ('solver:pod_repeat::e0:pod_loss',
     'corrected', 'solver:reweight', 'not_compared'),
    ('solver:pod_repeat::e1:pod_loss',
     'corrected', 'solver:reweight', 'not_compared'),
    ('episode:solver:pod_repeat',
     'corrected', 'solver:reweight', 'within_tol'),
    ('train:poisson125::e0:dram_params',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('episode:train:poisson125',
     'corrected', 'scrub:diskless', 'bit_identical'),
    ('train:poisson250::e0:dram_params',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('train:poisson250::e1:dram_params',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('train:poisson250::e2:shard_loss',
     'corrected', 'diskless', 'not_compared'),
    ('train:poisson250::e3:sdc_collective',
     'corrected', 'abft_inflight', 'not_compared'),
    ('train:poisson250::e4:dram_params',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('train:poisson250::e5:dram_params',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('episode:train:poisson250',
     'corrected', 'abft_inflight+diskless+scrub:diskless', 'within_tol'),
    ('train:poisson500::e0:sdc_collective',
     'corrected', 'abft_inflight', 'not_compared'),
    ('train:poisson500::e1:dram_opt_state',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('train:poisson500::e2:shard_loss',
     'corrected', 'diskless', 'not_compared'),
    ('train:poisson500::e3:shard_loss',
     'corrected', 'diskless', 'not_compared'),
    ('train:poisson500::e4:sdc_collective',
     'corrected', 'abft_inflight', 'not_compared'),
    ('train:poisson500::e5:dram_opt_state',
     'corrected', 'scrub:diskless', 'not_compared'),
    ('episode:train:poisson500',
     'corrected', 'abft_inflight+diskless+scrub:diskless', 'within_tol'),
    ('serve:poisson125::e0:dram_params',
     'corrected', 'scrub:restore', 'not_compared'),
    ('episode:serve:poisson125',
     'corrected', 'scrub:restore', 'bit_identical'),
    ('serve:poisson250::e0:dram_params',
     'corrected', 'scrub:restore', 'not_compared'),
    ('serve:poisson250::e1:dram_params',
     'corrected', 'scrub:restore', 'not_compared'),
    ('episode:serve:poisson250',
     'corrected', 'scrub:restore', 'bit_identical'),
    ('solver:poisson50::e0:dram_params',
     'corrected', 'solver:guard_restart', 'not_compared'),
    ('episode:solver:poisson50',
     'corrected', 'solver:guard_restart', 'within_tol'),
    ('solver:poisson150::e0:dram_params',
     'corrected', 'solver:guard_restart', 'not_compared'),
    ('solver:poisson150::e1:sdc_collective',
     'corrected', 'solver:replica_repair', 'not_compared'),
    ('solver:poisson150::e2:pod_loss',
     'corrected', 'solver:reweight', 'not_compared'),
    ('episode:solver:poisson150',
     'corrected', 'solver:guard_restart+solver:replica_repair+solver:reweight',
     'within_tol'),
    ('solver:poisson400::e0:sdc_collective',
     'corrected', 'solver:replica_repair', 'not_compared'),
    ('solver:poisson400::e1:shard_loss',
     'corrected', 'solver:failover', 'not_compared'),
    ('solver:poisson400::e2:pod_loss',
     'corrected', 'solver:reweight', 'not_compared'),
    ('solver:poisson400::e3:dram_params',
     'corrected', 'solver:guard_restart', 'not_compared'),
    ('solver:poisson400::e4:dram_params',
     'corrected', 'solver:guard_restart', 'not_compared'),
    ('solver:poisson400::e5:dram_params',
     'corrected', 'solver:guard_restart', 'not_compared'),
    ('episode:solver:poisson400',
     'corrected', 'solver:failover+solver:guard_restart+solver:replica_repair'
     '+solver:reweight',
     'within_tol'),
    ('train:clean_sweep:1x1:plain', 'clean', None, 'bit_identical'),
    ('train:clean_sweep:1x1:plain:7st', 'clean', None, 'bit_identical'),
    ('train:clean_sweep:1x1:protected', 'clean', None, 'bit_identical'),
    ('train:clean_sweep:1x1:protected:9st', 'clean', None, 'bit_identical'),
    ('train:clean_sweep:1x1:scrub', 'clean', None, 'bit_identical'),
    ('train:clean_sweep:2x2x2:plain', 'clean', None, 'bit_identical'),
    ('train:clean_sweep:2x2x2:plain:7st', 'clean', None, 'bit_identical'),
    ('serve:clean_sweep:4x2', 'clean', None, 'bit_identical'),
    ('serve:clean_sweep:4x2xscrub', 'clean', None, 'bit_identical'),
    ('solver:clean_sweep', 'clean', None, 'bit_identical'),
]
CAMPAIGN_BY_OUTCOME = {"corrected": 89, "absorbed": 1, "detected": 3,
                       "missed": 0, "false_alarm": 0, "clean": 10,
                       "skipped": 0}


def _count_encodes(calls):
    """Wrap `DisklessCheckpoint.encode` and `.verify` to count the leaves
    each call hands kernel #3; returns the function that unwraps them."""
    from repro_torch.ckpt.diskless import DisklessCheckpoint
    from repro_torch.tree import tree_leaves
    enc, ver = DisklessCheckpoint.encode, DisklessCheckpoint.verify

    def leaves(dc, state):
        return sum(1 for x in tree_leaves(state) if dc._encoded(x))

    def encode(self, state, *a, **kw):
        calls["encodes"] += 1
        calls["leaves"] += leaves(self, state)
        return enc(self, state, *a, **kw)

    def verify(self, state, *a, **kw):
        calls["verifies"] += 1
        calls["leaves"] += leaves(self, state)
        return ver(self, state, *a, **kw)

    DisklessCheckpoint.encode, DisklessCheckpoint.verify = encode, verify

    def undo():
        DisklessCheckpoint.encode, DisklessCheckpoint.verify = enc, ver
    return undo


def phase_chaos(torch, record):
    """The chaos campaign's CLI over the default space's train, serve and
    solver workloads on the card with its --check gate, counts zeroed just
    before it: every row the reference's 8-device campaign runs, with its
    outcome, rung and end state, through ElasticRuntime on the 1 x 1 and
    the logical (2, 2, 2) pod mesh (kernel #3 for every encode, re-key and
    scrub verify: shard loss, pod loss through rungs 3a and 3b and re-grow,
    a slow pod demoted), the protected serving engine on the logical (4, 2)
    mesh, the kernel drills and the float64 subspace solver (which launches
    no kernel of the port)."""
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.kernels import checksum_encode as kenc
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import chaos

    record["chaos_pairs"] = _campaign_pairs(torch)
    out = ROOT / "chiprun_out" / "chaos.json"
    out.parent.mkdir(exist_ok=True)
    calls = dict(encodes=0, verifies=0, leaves=0)
    undo = _count_encodes(calls)
    try:
        kmm.reset_counts()
        kfa.reset_counts()
        kenc.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):   # the matrix: file
            rc = chaos.main(["--space", "default", "--workload", "all",
                             "--json", str(out), "--markdown",
                             str(out.with_suffix(".md")), "--quiet",
                             "--check"])
        wall = time.perf_counter() - t0
        counts = dict(flash=kfa.launches, flash_plain=kfa.plain_calls,
                      acc=kmm.acc_launches, acc_plain=kmm.acc_plain_calls,
                      encode=kenc.launches, encode_plain=kenc.plain_calls)
    finally:
        undo()
    log("chaos", f"repro_torch.launch.chaos (default space, train, serve "
                 f"and solver) "
                 f"-> {rc} in {wall:.2f} s; launches: kernel #4 "
                 f"{counts['flash']}, kernel #2 {counts['acc']}, kernel #3 "
                 f"{counts['encode']} ({calls['encodes']} encodes + "
                 f"{calls['verifies']} scrub verifies); plain calls "
                 f"{counts['flash_plain']} / {counts['acc_plain']} / "
                 f"{counts['encode_plain']}")
    # --check: nothing missed or skipped, no false alarm, the uncovered
    # ledger empty
    if rc != 0:
        raise AssertionError(f"chaos CLI returned {rc}")
    # kernel #4: a clean and a checked run per flash spec (2); kernel #2:
    # three chained calls per state-flip spec and four (a warm repair) per
    # data-flip spec (3 + 3); kernel #3: one launch per encoded leaf of
    # every encode and every scrub verify
    want = dict(flash=4, flash_plain=0, acc=21, acc_plain=0,
                encode=calls["leaves"], encode_plain=0)
    if counts != want or not calls["verifies"]:
        raise AssertionError(f"the campaign did not run on kernels #4, #2 "
                             f"and #3 alone: {counts} (want {want})")
    d = json.loads(out.read_text())
    if not d["meta"]["device_name"] == torch.cuda.get_device_name(0):
        raise AssertionError(f"campaign meta {d['meta']}")
    events = d["events"]
    if [e["name"] for e in events] != [r[0] for r in CAMPAIGN_ROWS]:
        raise AssertionError(f"campaign rows {[e['name'] for e in events]}")
    for e, (name, outcome, rung, end) in zip(events, CAMPAIGN_ROWS):
        ok_end = (e["end_state"] == end if end is not None
                  else e["end_state"] in ("bit_identical", "within_tol"))
        if e["outcome"] != outcome or e["rung"] != rung or not ok_end:
            raise AssertionError(f"{name}: {e['outcome']} {e['rung']} "
                                 f"{e['end_state']} ({e['note']})")
        pod = e["kind"] in ("pod_loss", "slow_pod") or ":sh1" in name \
            or name.startswith(("train:shard_loss", "train:dram+podloss",
                                "train:pod_repeat", "episode:train:dram+pod",
                                "episode:train:pod_repeat"))
        if name in CHAOS_ROWS or pod:
            log("chaos", f"{name}: {e['outcome']}, rung {e['rung']}, "
                         f"{e['end_state']} (max diff {e['max_abs_diff']})"
                         + (f": {e['note']}" if pod else ""))
    summ = d["summary"]
    if summ["by_outcome"] != CAMPAIGN_BY_OUTCOME \
            or summ["missed_anywhere"] or summ["false_alarms"]:
        raise AssertionError(f"by outcome {summ['by_outcome']}, missed "
                             f"{summ['missed_anywhere']}, false alarms "
                             f"{summ['false_alarms']}")
    eps = {k: v for k, v in d["episodes"]["by_outcome"].items() if v}
    if eps != {"corrected": 17}:
        raise AssertionError(f"episodes {eps}")
    solver_eps = [e for e in d["episodes"]["episodes"]
                  if e["workload"] == "solver"]
    rate = d["episodes"]["sustained_rate_at_parity"]["solver"]
    if len(solver_eps) != 6 or any(e["outcome"] != "corrected"
                                   for e in solver_eps) \
            or rate["sustained_rate_per_1k"] != 400.0:
        raise AssertionError(f"solver episodes {solver_eps}, rate {rate}")
    ledger = [s["surface"] for s in d["uncovered_surfaces"]]
    if ledger:
        raise AssertionError(f"uncovered ledger {ledger}")
    solver_wall = sum(e["wall_s"] for e in events
                      if e["workload"] == "solver" and not e["episode"])
    log("chaos", f"{len(events)} rows as the reference's 8-device "
                 f"campaign: {summ['by_outcome']}; episodes {eps}; solver "
                 f"sustained rate at parity {rate['sustained_rate_per_1k']} "
                 f"events per 1k iterations (rates {rate['rates_tested']}); "
                 f"solver rows {solver_wall:.3f} s; missed [], false alarms "
                 f"[]; uncovered ledger {ledger}")
    record["chaos"] = dict(rc=rc, wall_s=wall, counts=counts,
                           encode_calls=calls, by_outcome=summ["by_outcome"],
                           episodes=eps, solver_rate=rate,
                           solver_wall_s=solver_wall)
    return counts


# phases 12 and 13: the protected reductions and the at-rest scrub at full
# width
SERVE_FT_GEN = 16
TRAIN_FT_STEPS = 6
def _share_line(sh):
    """One log line of `_pair_stats` and the reduction's own time."""
    return (f"{sh['pairs']} pairs, reduce off {sh['off_ms']:.3f} ms, "
            f"correct {sh['on_ms']:.3f} ms (medians); paired difference "
            f"{sh['diff_ms']:+.3f} ms (order effect {sh['order_ms']:+.3f}; "
            f"median {sh['diff_median_ms']:+.3f}, quartiles "
            f"{sh['diff_q1_ms']:+.3f} / {sh['diff_q3_ms']:+.3f}, range "
            f"{sh['diff_min_ms']:+.3f} / {sh['diff_max_ms']:+.3f}); the "
            f"reduction alone {sh.get('reduce_ms', float('nan')):.3f} ms")


# unprotected and protected train steps in blocks of STEP_BLOCK (the first
# of each a warm-up), in this order: the two orders of a pair of blocks
# equally often
STEP_BLOCKS = ("off", "correct", "correct", "off",
               "off", "correct", "correct", "off")
STEP_BLOCK = 4


def _pair_stats(off, on, off_first):
    """Two series of walls (ms) taken in turns, pair i with the unprotected
    one first where ``off_first[i]``: each one's median; the paired
    differences on - off, their mean (the mean of each order's mean, which
    cancels what the place in a pair adds: ``order_ms``), median,
    quartiles and range."""
    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    def mean(xs):
        return sum(xs) / len(xs)
    d = [b - a for a, b in zip(off, on)]
    d_off = mean([x for x, o in zip(d, off_first) if o])
    d_on = mean([x for x, o in zip(d, off_first) if not o])
    ds = sorted(d)
    return dict(pairs=len(d), off_ms=med(off), on_ms=med(on),
                diff_ms=(d_off + d_on) / 2, order_ms=(d_off - d_on) / 2,
                diff_median_ms=med(d), diff_q1_ms=ds[len(d) // 4],
                diff_q3_ms=ds[3 * len(d) // 4], diff_min_ms=ds[0],
                diff_max_ms=ds[-1], off=list(off), on=list(on))


def phase_serve_ft(torch, record, card, device="cuda", smoke=False):
    """repro_torch.launch.serve.run on Qwen2-0.5B at full width in fp32 (the
    bit-flip model is on 32-bit words), ABFT verify on kernel #1: the
    protected logits reduction clean, with an SDC drill at decode step 3,
    and with the at-rest scrub repairing a KV flip and a params flip (the
    campaign's ``_flip_engine_bit``); token streams identical.  ``device``
    and ``smoke`` let the phase run on the CPU at the smoke size."""
    import numpy as np
    from repro_torch.chaos.campaign import _flip_engine_bit
    from repro_torch.chaos.faults import FaultSpec, SDCPlan
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.dist.collectives import abft_psum
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.launch.serve import run
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = smoke_config("qwen2-0.5b") if smoke else get_config("qwen2-0.5b")
    per_pass = 7 * cfg.n_layers                     # 168 at full width
    lens = np.random.RandomState(0).randint(16, 129, size=8).tolist()
    base = dict(smoke=smoke, requests=8, slots=4, prompt_lens=lens,
                gen=SERVE_FT_GEN, abft_mode="verify", abft_backend="cuda",
                kernel_dtype="fp32", dtype="float32", device=device,
                verbose=False)
    runs = {}

    def serve(what, on_step=None, **kw):
        def on_warm(engine):
            kmm.reset_counts()
        finished, eng = run("qwen2-0.5b", on_warm=on_warm, on_step=on_step,
                            **base, **kw)
        st = eng.stats
        n = per_pass * (st.prefills + st.decode_steps)
        got = (kmm.launches, kmm.plain_calls)
        if got != ((n, 0) if device == "cuda" else (0, n)):
            raise AssertionError(f"{what}: kernel #1 launches / plain calls "
                                 f"{got}, want {n} launches")
        if len(finished) != 8 or any(len(r.output) != SERVE_FT_GEN
                                     for r in finished):
            raise AssertionError(f"{what}: not every request finished")
        s = st.summary()
        runs[what] = dict(summary=s, launches=got[0])
        log("serve-ft", f"{what}: {st.decode_steps} decode steps, mean "
                        f"decode step {s['clean_step_ms']:.3f} ms, "
                        f"detections {s['detections']}, corrections "
                        f"{s['corrections']}, kernel #1 launches {got[0]}")
        return {r.rid: r.output for r in finished}, eng

    toks_off, eng_off = serve("reduce off")
    toks, eng = serve("reduce correct", abft_reduce="correct")
    if eng.stats.detections:
        raise AssertionError("a clean protected run reported a detection")
    if toks != toks_off:
        raise AssertionError("the protected run's tokens differ from the "
                             "unprotected run's")
    del eng
    drilled, eng = serve("drill", abft_reduce="correct",
                         drill=SDCPlan(((3, 0, 1e4),)))
    evs = eng.stats.events
    if drilled != toks or len(evs) != 1 or not (
            evs[0].detected and evs[0].corrected and evs[0].row >= 0
            and evs[0].col >= 0) or eng.stats.detections != 1:
        raise AssertionError(f"SDC drill: tokens equal {drilled == toks}, "
                             f"events {evs}")
    drill = dataclasses.asdict(evs[0])
    log("serve-ft", f"SDC drill at decode step 3 (shard 0, delta 1e4): "
                    f"detected, corrected, located ({evs[0].row}, "
                    f"{evs[0].col}); drilled step {1e3 * evs[0].wall_s:.3f} "
                    f"ms, recovery latency {1e3 * evs[0].recovery_s:.3f} ms; "
                    "tokens identical to the undrilled run")
    del eng
    flips = {2: FaultSpec(kind="dram_kv_cache", workload="serve", step=2,
                          bit=30),
             4: FaultSpec(kind="dram_params", workload="serve", step=4,
                          bit=30)}
    fired = []

    def flip(engine, step):
        if step in flips:
            fired.append(_flip_engine_bit(engine, flips.pop(step)))

    scrubbed, eng = serve("scrub", on_step=flip, abft_reduce="correct",
                          scrub_every=1)
    st = eng.stats
    sev = [(e.step, e.domain, e.slot, e.repaired) for e in st.scrub_events]
    if scrubbed != toks or len(fired) != 2 or sev != [
            (2, "kv", 0, True), (4, "params", -1, True)] \
            or st.scrub_checks != st.decode_steps:
        raise AssertionError(f"scrub: tokens equal {scrubbed == toks}, "
                             f"flips {fired}, events {st.scrub_events}")
    scrub_ms = 1e3 * sum(st.scrub_s) / len(st.scrub_s)
    log("serve-ft", f"scrub every decode step: {st.scrub_checks} checks, "
                    f"{scrub_ms:.3f} ms each on average; the KV flip "
                    f"({fired[0][0]}) rebuilt in slot 0 and the params flip "
                    f"({fired[1][0]}) restored in "
                    f"{1e3 * st.scrub_events[0].wall_s:.3f} / "
                    f"{1e3 * st.scrub_events[1].wall_s:.3f} ms; tokens "
                    "identical to the unscrubbed run")
    for _, undo in fired:
        undo()
    del eng

    # the reduction's share of a decode step: the unprotected engine and a
    # protected one on its prepared weights serve the same requests, one
    # decode step each in turns (the order swapped every step), no scrub
    pair = {"off": eng_off, "correct": ServeEngine(
        eng_off.cfg, eng_off.params, slots=4, max_len=eng_off.max_len,
        abft_mode="verify", abft_backend="cuda", kernel_dtype="fp32",
        abft_reduce="correct")}
    pair["correct"].warm(prompt_len=lens[0])
    eng_off.reset()
    rs = np.random.RandomState(0)          # launch.serve.run's prompts
    prompts = [rs.randint(0, eng_off.cfg.vocab_size, n).tolist()
               for n in lens]
    for e in pair.values():
        for i, pr in enumerate(prompts):
            e.submit(Request(rid=i, prompt=pr, max_new_tokens=SERVE_FT_GEN))
    done = {k: [] for k in pair}
    turn = 0
    while any(any(e.active) or e.queue for e in pair.values()):
        for k in (("off", "correct") if turn % 2 == 0
                  else ("correct", "off")):
            done[k] += pair[k].run(max_steps=1)
        turn += 1
    for k, fin in done.items():
        if {r.rid: r.output for r in fin} != toks_off:
            raise AssertionError(f"decode steps in turns: the {k} engine's "
                                 "tokens differ from the first run's")
    off_w = [1e3 * w for w in pair["off"].stats.decode_step_s]
    share = _pair_stats(off_w,
                        [1e3 * w for w in pair["correct"].stats.decode_step_s],
                        [i % 2 == 0 for i in range(len(off_w))])
    if device == "cuda":
        # the reduction alone: abft_psum over the [1, slots, 1, V] partial
        # logits of one decode step, as the verified unembed calls it
        g = torch.Generator(device="cuda").manual_seed(12)
        parts = torch.randn((1, 4, 1, eng_off.cfg.vocab_size), generator=g,
                            device="cuda")
        flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                            device="cuda")
        share["reduce_ms"] = time_ms(torch, lambda: abft_psum(
            parts, 0, f=2, mode="correct", with_info=True), 20, flush)
        del parts, flush
    del pair, eng_off
    log("serve-ft", "decode step, in turns: " + _share_line(share)
        + f"; tokens of the protected runs equal to the unprotected run's; "
          f"{card}")
    if device == "cuda":
        torch.cuda.empty_cache()
    record["serve_ft"] = dict(
        runs=runs, drill=drill, prompt_lens=lens, gen=SERVE_FT_GEN,
        scrub_ms=scrub_ms, scrub_events=[dataclasses.asdict(e)
                                         for e in st.scrub_events],
        step_ms=share, tokens_equal_unprotected=True, card=card)


def _max_diff(torch, a, b):
    """(bit-identical, max |a - b|) over two trees of tensors."""
    from repro_torch.tree import tree_leaves
    same, worst = True, 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if not torch.equal(x, y):
            same = False
            if x.is_floating_point():
                worst = max(worst, float((x.double() - y.double()).abs()
                                         .max()))
    return same, worst


def phase_train_ft(torch, record, card, device="cuda", smoke=False):
    """ElasticRuntime (mesh 1 x 1) on Qwen2-0.5B at full width in fp32,
    batch 16 x seq 128, the protected step (deferred reduction, abft_reduce
    "correct", ABFT verify on kernel #1) with an encode and an at-rest scrub
    every step: an SDC at step 2 flagged, a params flip at step 3 and an
    optimizer-state flip at step 4 rolled back by the scrub, the end state
    within TrainConfig.tol of the clean run's; kernel #3 launched once per
    state leaf for each encode and each verify."""
    from repro_torch.chaos.campaign import TrainConfig, _flip_state_leaf
    from repro_torch.chaos.faults import FaultSpec
    from repro_torch.configs.base import ShapeConfig, get_config, smoke_config
    from repro_torch.dist.collectives import abft_psum_tree
    from repro_torch.ft.runtime import ElasticRuntime, FTPolicy, stack_view
    from repro_torch.kernels import checksum_encode as kenc
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import StepOptions, build_train_step
    from repro_torch.tree import (stack_layers, tree_leaves, tree_map,
                                  unstack_layers)

    cfg = dataclasses.replace(
        smoke_config("qwen2-0.5b") if smoke else get_config("qwen2-0.5b"),
        dtype="float32")
    shape = ShapeConfig("ft", 16 if smoke else 128, 8 if smoke else 16,
                        "train")
    adamw = AdamWConfig(lr=1e-3, total_steps=TRAIN_FT_STEPS, warmup_steps=1)
    protected = StepOptions(remat=not smoke, abft_mode="verify",
                            defer_grad_reduce=True, abft_reduce="correct")
    policy = FTPolicy(diskless_every=1, disk_every=10 ** 6, scrub_every=1)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def loop(opts, steps, faults=False):
        rt = ElasticRuntime(cfg, shape, (1, 1), adamw=adamw, opts=opts,
                            policy=policy, device=device)
        drill = build_train_step(
            cfg, shape, adamw,
            dataclasses.replace(opts, sdc_inject=(0, 1e4))) if faults \
            else None
        out = dict(oks=[], walls=[], scrub_s=[], reports=[], flips=[])
        try:
            state = rt.init_state(0)
            n_float = sum(1 for x in tree_leaves(stack_view(state, 1))
                          if x.is_floating_point())
            kenc.reset_counts()
            for i in range(steps):
                rt.checkpoint(i, state)
                if faults and i in (3, 4):
                    kind, group = (("dram_params", "params") if i == 3
                                   else ("dram_opt_state", "opt"))
                    state, leaf = _flip_state_leaf(state, group, FaultSpec(
                        kind=kind, workload="train", step=i, bit=30))
                    out["flips"].append(leaf)
                sync()
                t0 = time.perf_counter()
                state, rep = rt.scrub(i, state)
                sync()
                out["scrub_s"].append(time.perf_counter() - t0)
                if rep is not None:
                    out["reports"].append(dataclasses.asdict(rep))
                if faults and i == 2:
                    batch = rt.place_batch(i)
                    sync()
                    t0 = time.perf_counter()
                    state, m = drill(state, batch)
                    sync()
                    out["walls"].append(time.perf_counter() - t0)
                else:
                    state, m = rt.train_step(i, state)
                    out["walls"].append(rt.step_times[-1])
                if "abft_ok" in m:
                    out["oks"].append(float(m["abft_ok"]))
            out.update(launches=kenc.launches, plain=kenc.plain_calls,
                       encodes=len(rt.timings["encode"]),
                       encode_s=list(rt.timings["encode"]), n_float=n_float,
                       recoveries=dict(rt.recoveries), loss=float(m["loss"]))
            return state, out
        finally:
            rt.close()

    clean, c = loop(protected, TRAIN_FT_STEPS)
    if c["oks"] != [1.0] * TRAIN_FT_STEPS or c["reports"]:
        raise AssertionError(f"clean protected run: abft_ok {c['oks']}, "
                             f"scrub trips {c['reports']}")
    faulted, f = loop(protected, TRAIN_FT_STEPS, faults=True)
    want = f["n_float"] * 2 * TRAIN_FT_STEPS
    if f["encodes"] != TRAIN_FT_STEPS or (f["launches"], f["plain"]) != (
            (want, 0) if device == "cuda" else (0, want)):
        raise AssertionError(f"kernel #3: {f['launches']} launches, "
                             f"{f['plain']} plain calls over "
                             f"{f['encodes']} encodes + {TRAIN_FT_STEPS} "
                             f"verifies of {f['n_float']} leaves")
    oks = [1.0, 1.0, 0.0] + [1.0] * (TRAIN_FT_STEPS - 3)
    trips = [r["step"] for r in f["reports"] if r["rolled_back"]]
    if f["oks"] != oks or trips != [3, 4] or f["recoveries"]["scrub"] != 2:
        raise AssertionError(f"faulted run: abft_ok {f['oks']}, scrub "
                             f"trips {f['reports']}")
    same, diff = _max_diff(torch, faulted, clean)
    tol = TrainConfig().tol
    if not diff <= tol:
        raise AssertionError(f"end state {diff} from the clean run's > {tol}")
    del faulted, clean
    log("train-ft", f"{TRAIN_FT_STEPS} protected steps: SDC at step 2 "
                    f"flagged (abft_ok {f['oks']}); flips {f['flips']} "
                    f"rolled back by the scrub at steps {trips} (residuals "
                    f"{[r['residual'] for r in f['reports']]}); end state "
                    f"{'bit-identical to' if same else 'within tol of'} the "
                    f"clean run's, max |diff| {diff:.3g} (tol {tol}); kernel "
                    f"#3 {f['launches']} launches = {f['n_float']} leaves x "
                    f"({f['encodes']} encodes + {TRAIN_FT_STEPS} verifies), "
                    f"plain {f['plain']}")

    # the reduction's share of a step: unprotected and protected steps on
    # one state and batch in blocks (STEP_BLOCKS), each new state dropped;
    # pair i is the i-th timed step of an unprotected block and of the
    # protected block beside it
    rt = ElasticRuntime(cfg, shape, (1, 1), adamw=adamw, opts=protected,
                        policy=policy, device=device)
    try:
        state, batch = rt.init_state(0), rt.place_batch(0)
        steps = {"off": build_train_step(
            cfg, shape, adamw,
            dataclasses.replace(protected, abft_reduce="off")),
            "correct": build_train_step(cfg, shape, adamw, protected)}
        step_w = {k: [] for k in steps}
        for k in STEP_BLOCKS:
            for j in range(STEP_BLOCK):
                sync()
                t0 = time.perf_counter()
                out = steps[k](state, batch)
                sync()
                if j:
                    step_w[k].append(1e3 * (time.perf_counter() - t0))
                del out
        # each pair of blocks holds one unprotected block
        off_first = [STEP_BLOCKS[2 * (i // (STEP_BLOCK - 1))] == "off"
                     for i in range(len(step_w["off"]))]
        share = _pair_stats(step_w["off"], step_w["correct"], off_first)
        if device == "cuda":
            # the reduction alone, as the protected step makes it: the
            # gradients stacked into the reference's leaves, abft_psum_tree
            # over them, the result unstacked
            g = torch.Generator(device="cuda").manual_seed(13)
            grads = tree_map(lambda x: torch.randn(
                x.shape, generator=g, device="cuda"), state["params"])

            def reduce():
                red, _ = abft_psum_tree(
                    tree_map(lambda x: x[None], stack_layers(grads)), 0, 1,
                    mode="correct")
                return unstack_layers(red, grads)
            flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                device="cuda")
            share["reduce_ms"] = time_ms(torch, reduce, 5, flush)
            del grads, flush
        del state, batch
    finally:
        rt.close()

    def med(xs):
        xs = sorted(xs[1:])
        return xs[len(xs) // 2]

    walls = dict(
        step_pairs=share, drilled_step_s=f["walls"][2],
        encode_s=med(c["encode_s"]), verify_s=med(c["scrub_s"]),
        trip_s=[r["wall_s"] for r in f["reports"]])
    log("train-ft", "step, in blocks: " + _share_line(share))
    log("train-ft", "walls " + json.dumps(
        {k: v for k, v in walls.items() if k != "step_pairs"}) + f"; {card}")
    if device == "cuda":
        torch.cuda.empty_cache()
    record["train_ft"] = dict(steps=TRAIN_FT_STEPS, oks=f["oks"],
                              flips=f["flips"], reports=f["reports"],
                              end_bit_identical=same, end_max_diff=diff,
                              launches=f["launches"], n_float=f["n_float"],
                              walls=walls, card=card)
    return f["launches"]


# phase 14: paged serving under traffic at full width
TRAFFIC_FULL = dict(n_requests=24, vocab=151936, arrival="open",
                    rate_per_step=0.25, zipf_a=1.8, prompt_min=288,
                    prompt_max=1536, out_min=8, out_max=64,
                    shared_prefix_len=256, seed=9)
TRAFFIC_SMOKE = dict(TRAFFIC_FULL, vocab=512, prompt_min=18, prompt_max=96,
                     out_min=2, out_max=8, shared_prefix_len=16)


def _timed_call(torch, eng, name, walls, device):
    """Append the wall of every call of ``eng.<name>`` (a method without a
    result) to ``walls``, device synchronized before and after."""
    inner = getattr(eng, name)

    def timed(*args):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(*args)
        if device == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    setattr(eng, name, timed)


def _count_forwards(eng):
    """Counts the paged engine's prefill passes (whole prompts and
    chunks): kernel #1 runs 7 projections a layer in each."""
    n = {"forwards": 0}
    for name in ("_prefill_impl", "_chunk_forward"):
        inner = getattr(eng, name)

        def wrap(*a, _inner=inner, **kw):
            n["forwards"] += 1
            return _inner(*a, **kw)

        setattr(eng, name, wrap)
    return n


@contextlib.contextmanager
def _capture_oneshot(kmm, captured):
    """While the block runs, keep in ``captured`` the operands of kernel
    #1's first call at each shape and tile (the launches still count)."""
    real = kmm.abft_matmul_cuda

    def capture(a, b, wm, wn, **kw):
        key = (tuple(a.shape), tuple(b.shape), a.dtype,
               tuple(sorted(kw.items(), key=lambda it: it[0])))
        if key not in captured:
            captured[key] = ((a.clone(), b, wm, wn), kw)
        return real(a, b, wm, wn, **kw)

    kmm.abft_matmul_cuda = capture
    try:
        yield captured
    finally:
        kmm.abft_matmul_cuda = real


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def phase_traffic(torch, record, card, device="cuda", smoke=False):
    """Paged serving under traffic: PagedServeEngine on Qwen2-0.5B at full
    width in fp32 (the page flips flip 32-bit words), ABFT verify on kernel
    #1, the protected logits reduction ("correct"), a page scrub every
    decode step, 8 slots of 2048 tokens in pages of 16, chunked prefill of
    256, the prefix cache and the SLO scheduler, replaying an open-loop
    trace of 24 requests behind a 256-token system prompt through
    serve.traffic.run_trace: (a) clean, (b) under two SDCs on the logits
    reduction and two page flips (token streams equal, 4/4 detected and
    corrected), (c) without chunking, prefix cache or scheduler against the
    contiguous ServeEngine on the same weights (token streams identical;
    the whole-step medians give the cost of paging), (d) the chaos CLI
    over the traffic workload (the CPU run's rows) and the obs recorder
    with its gate.  ``device`` and ``smoke`` rehearse it on the CPU."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.ft.failures import SDCInjector, SDCPlan
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.launch import chaos
    from repro_torch.launch import obs as obs_cli
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine
    from repro_torch.serve.scheduler import SchedPolicy, SLOScheduler
    from repro_torch.serve.traffic import (TrafficConfig, compare,
                                           make_trace, run_trace)

    cfg = dataclasses.replace(
        smoke_config("qwen2-0.5b") if smoke else get_config("qwen2-0.5b"),
        dtype="float32")
    per_pass = 7 * cfg.n_layers                     # 168 at full width
    tcfg = TrafficConfig(**(TRAFFIC_SMOKE if smoke else TRAFFIC_FULL))
    trace = make_trace(tcfg)
    n = tcfg.n_requests
    geo = dict(slots=4, max_len=128, page_size=8, chunk_prefill=16) \
        if smoke else dict(slots=8, max_len=2048, page_size=16,
                           chunk_prefill=256)
    abft = dict(abft_mode="verify", abft_backend="cuda",
                kernel_dtype="fp32", abft_reduce="correct")
    params = tf.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg)

    def paged(sdc=None, **kw):
        kw = {**dict(geo, prefix_cache=True, scrub_every=1,
                     scheduler=SLOScheduler(SchedPolicy(max_queue=4 * n))),
              **kw}
        eng = PagedServeEngine(cfg, params, sdc=sdc, **abft, **kw)
        eng.warm(prompt_len=8, decode_steps=2)
        eng.reset()
        return eng

    # (a) the clean replay: the main path, counts zeroed just before it
    eng = paged()
    params = eng.params          # prepared once (encoded weights), shared
    fwd = _count_forwards(eng)
    seen = []
    kmm.reset_counts()
    clean = run_trace(eng, trace, on_step=lambda e, s: seen.append(s))
    launches, plain = kmm.launches, kmm.plain_calls
    want = per_pass * (len(seen) + fwd["forwards"])
    if (launches, plain) != ((want, 0) if device == "cuda" else (0, want)):
        raise AssertionError(f"kernel #1 launches / plain calls "
                             f"{(launches, plain)}, want {want} launches "
                             f"({len(seen)} decode steps + "
                             f"{fwd['forwards']} prefill passes)")
    if clean.n_finished != n or clean.detections or clean.n_rejected:
        raise AssertionError(f"clean replay: {clean.asdict()}")
    kv = eng.kv
    if not all(t.device.type == device for t in
               list(kv.pools.values()) + list(kv._fp.values())
               + list(kv._esum.values())):
        raise AssertionError("the page pools or their checksums left the "
                             "device")
    kv.check_invariants()
    if not kv.checksums_consistent():
        raise AssertionError("page checksums inconsistent after the replay")
    pool_bytes = sum(p.numel() * p.element_size() for p in kv.pools.values())
    scrub_ms = [1e3 * w for w in eng.stats.scrub_s]
    # the pages' share of a scrub: their flags alone, brought to the host
    # in one transfer as the scrub brings them
    page_ms = []
    for _ in range(20):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv.trip_flags().cpu()
        page_ms.append(1e3 * (time.perf_counter() - t0))
    a = dict(clean.asdict(), executed_steps=len(seen),
             prefill_passes=fwd["forwards"], launches=launches,
             scrub_ms_median=_median(scrub_ms),
             scrub_ms_mean=sum(scrub_ms) / len(scrub_ms),
             page_flags_ms_median=_median(page_ms),
             kv_stats=dataclasses.asdict(kv.stats), pool_bytes=pool_bytes)
    log("traffic", f"(a) clean: {n}/{n} requests, {len(seen)} decode steps, "
                   f"{fwd['forwards']} prefill passes, p50 / p99 TTFT "
                   f"{clean.p50_ttft_ms:.1f} / {clean.p99_ttft_ms:.1f} ms, "
                   f"{clean.tok_per_s:.1f} tok/s, the whole scrub (params' "
                   f"sums and page pools, one transfer) "
                   f"{a['scrub_ms_median']:.3f} ms a step (median), the page "
                   f"flags alone {a['page_flags_ms_median']:.3f} ms "
                   f"(median of 20), prefix "
                   f"hits {clean.prefix_hits}, pools {pool_bytes / 1e6:.1f} "
                   f"MB, kernel #1 launches {launches} = {per_pass} x "
                   f"({len(seen)} + {fwd['forwards']}), plain {plain}")
    del eng, kv

    # (b) the same trace under two SDCs and two page flips, at executed
    # steps picked as launch/obs.py picks them
    sdc_steps = (seen[len(seen) // 3], seen[len(seen) // 2])
    dram_steps = [seen[2 * len(seen) // 3], seen[(5 * len(seen)) // 6]]
    flips = []

    def dram(e, step):
        if step in dram_steps and len(flips) < len(dram_steps):
            live = e.kv.live_pages()
            key = next(iter(e.kv.pools))
            phys = live[len(flips) % len(live)]
            e.kv.corrupt_page(key, phys)
            flips.append((step, key, phys))

    eng = paged(sdc=SDCInjector(SDCPlan(tuple((s, 0, 1e4)
                                              for s in sdc_steps))))
    captured = {}           # kernel #1's operands on (b)'s and (c)'s path
    with _capture_oneshot(kmm, captured):
        fault = run_trace(eng, trace, on_step=dram)
    slo = compare(clean, fault, expected_faults=4)
    page_evs = [(e.step, e.leaf, e.page) for e in eng.stats.scrub_events]
    if (fault.outputs != clean.outputs or len(flips) != 2
            or slo["faults_missed"] or slo["faults_detected"] != 4
            or slo["faults_corrected"] != 4 or fault.sdc_corrected != 2
            or page_evs != [f for f in flips]):
        raise AssertionError(f"drilled replay: tokens equal "
                             f"{fault.outputs == clean.outputs}, flips "
                             f"{flips}, page repairs {page_evs}, {slo}")
    eng.kv.check_invariants()
    b = dict(fault.asdict(), slo=slo, sdc_steps=list(sdc_steps),
             flips=flips, events=[dataclasses.asdict(e)
                                  for e in eng.stats.events])
    log("traffic", f"(b) drilled: SDCs at decode steps {list(sdc_steps)} "
                   f"and page flips {[(s, p) for s, _, p in flips]}: 4/4 "
                   f"detected and corrected, tokens identical to (a); p50 / "
                   f"p99 TTFT {fault.p50_ttft_ms:.1f} / "
                   f"{fault.p99_ttft_ms:.1f} ms, {fault.tok_per_s:.1f} "
                   f"tok/s")
    del eng

    # (c) parity: no chunking, prefix cache or scheduler, no scrub, against
    # the contiguous engine on the same prepared weights, in the order
    # paged, contiguous, contiguous, paged; whole steps timed, and the
    # paged engine's gather and write-back on their own
    walls = {"paged": [], "contiguous": []}
    paging = {"_pre_decode": [], "_post_decode": []}
    outs = []
    for name in ("paged", "contiguous", "contiguous", "paged"):
        if name == "paged":
            e = paged(chunk_prefill=0, prefix_cache=False, scheduler=None,
                      scrub_every=0)
            for hook, ws in paging.items():
                _timed_call(torch, e, hook, ws, device)
        else:
            e = ServeEngine(cfg, params, slots=geo["slots"],
                            max_len=geo["max_len"], **abft)
            e.warm(prompt_len=8, decode_steps=2)
            e.reset()
        _timed_call(torch, e, "_step", walls[name], device)
        with _capture_oneshot(kmm, captured):
            outs.append(run_trace(e, trace).outputs)
        del e
    if any(o != outs[0] for o in outs):
        raise AssertionError("(c): the paged engine's tokens differ from the "
                             "contiguous engine's")
    med = {k: 1e3 * _median(w) for k, w in walls.items()}
    gather_ms = 1e3 * _median(paging["_pre_decode"])
    write_ms = 1e3 * _median(paging["_post_decode"])
    c = dict(step_ms=med, step_diff_ms=med["paged"] - med["contiguous"],
             gather_ms=gather_ms, write_back_ms=write_ms,
             steps={k: len(w) for k, w in walls.items()},
             same_as_a=outs[0] == clean.outputs)
    log("traffic", f"(c) parity, runs paged / contiguous / contiguous / "
                   f"paged: tokens identical; whole decode step (median of "
                   f"{len(walls['paged'])}) paged {med['paged']:.3f} ms, "
                   f"contiguous {med['contiguous']:.3f} ms, difference "
                   f"{c['step_diff_ms']:+.3f} ms; the paging itself: gather "
                   f"{gather_ms:.3f} ms + write-back and page re-arm "
                   f"{write_ms:.3f} ms a step (medians); (a)'s chunked, "
                   f"prefix-cached tokens "
                   f"{'equal' if c['same_as_a'] else 'differ from'} these")

    # kernel #1 against its plain version on the operands (b) and (c) gave
    # it: decode (m = slots), prefill chunks, suffix and whole-prompt
    # buckets, at every projection's k and n (outside the counted run)
    held = []
    for args, kw in captured.values():
        errs = hold_oneshot(torch, kmm, args, kw,
                            kmm.abft_matmul_cuda(*args, **kw))
        held.append(dict(m=args[0].shape[0], k=args[0].shape[1],
                         n=args[1].shape[1], tile=[kw["bm"], kw["bn"]],
                         splits=kw.get("splits"), max_abs_err=errs[0],
                         err_cs_col=errs[1], err_cs_row=errs[2]))
    ms = sorted({h["m"] for h in held})
    if not {geo["slots"], geo["chunk_prefill"]} <= set(ms):
        raise AssertionError(f"kernel #1 operands captured at m {ms}, not at "
                             f"decode's {geo['slots']} and a chunk's "
                             f"{geo['chunk_prefill']}")
    held_err = max(h["max_abs_err"] for h in held)
    c["kernel_held"] = held
    log("traffic", f"kernel #1 held against its plain version on the "
                   f"operands of {len(held)} shapes and tiles of (b) and (c) "
                   f"(m in {ms}; k, n of every projection): c, checksum "
                   f"columns and residuals within RTOL {RTOL:g}, max |c - "
                   f"plain| {held_err:.3g}")
    del captured

    # (d) the two CLIs on the device: the chaos campaign's traffic rows as
    # the CPU run's, and the obs recorder with its gate
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    rows = {}
    for dev in dict.fromkeys((device, "cpu")):
        path = out / f"traffic_{dev}.json"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = chaos.main(["--device", dev, "--space", "traffic-smoke",
                             "--workload", "traffic", "--json", str(path),
                             "--quiet"])
        d = json.loads(path.read_text())
        rows[dev] = [(e["name"], e["outcome"], e["rung"], e["end_state"])
                     for e in d["events"]]
        if rc != 0 or d["summary"]["missed_anywhere"] \
                or d["summary"]["false_alarms"]:
            raise AssertionError(f"traffic campaign on {dev}: rc {rc}, "
                                 f"{d['summary']}")
    if rows[device] != rows["cpu"] or [r[1] for r in rows[device]] != \
            ["corrected"] * 5 + ["clean"]:
        raise AssertionError(f"traffic campaign rows {rows}")
    log("traffic", f"(d) chaos CLI, traffic-smoke: {len(rows[device])} rows "
                   f"as the CPU run's (5 corrected, the sweep clean, none "
                   f"skipped)")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        obs_cli.main(["record", "--device", device, "--check", "--json",
                      str(out / "obs.json")])
    r = json.loads((out / "obs.json").read_text())
    ov = r["overhead"]
    log("traffic", f"(d) obs record --check: {r['n_complete_lifecycles']} "
                   f"complete lifecycles, {r['dropped_events']} dropped, "
                   f"faults missed {r['slo_under_fault']['faults_missed']}, "
                   f"overhead {ov['overhead_pct']:+.2f} % (summed on "
                   f"{ov['obs_on_s']:.4f} s over summed off "
                   f"{ov['obs_off_s']:.4f} s, {ov['pairs']} interval pairs "
                   f"over {ov['repeats']} replays; median pair "
                   f"{ov['median_pair_pct']:+.2f} %; budget "
                   f"{ov['budget_pct']} %); {card}")
    record["traffic"] = dict(
        config=dataclasses.asdict(tcfg), engine=geo, clean=a, drilled=b,
        parity=c, campaign_rows=rows[device],
        obs=dict(overhead=ov, n_complete=r["n_complete_lifecycles"],
                 dropped=r["dropped_events"], backend=r["config"]["backend"]),
        card=card)
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches, held_err


# phase 15: the subspace solver and the FT context at full size
SOLVER_N = 24576          # 12 subspaces of 2 x 2048 unknowns, float64
SOLVER_TOL_X = 1e-8       # max |x - x_true| and max |A x - b|
CTX_RTOL = 1e-5           # floating_point recovery, relative to max |leaf|
CTX_MODES = (("floating_point", 1), ("floating_point", 2), ("gf256", 1),
             ("gf256", 2), ("xor", 1))
CTX_LOST = {1: [2], 2: [1, 3]}


def phase_solver(torch, record, card, device="cuda", smoke=False):
    """The subspace solver and the FT context on the card: (a) a clean
    RedundantSubspaceCG solve of the 1D Poisson system at n = 24576 in
    float64 (zero trips, x within 1e-8 of RandomState(0)'s x_true and A x
    of b); (b) the same solve drilled with an SDC in subspace 3 replica 0 at
    iteration 2, a flip of argmax |x| at iteration 3 and pod 1 lost there
    (replica repair, guard restart and failovers, converged); (c) FTContext
    (p = 4) over the seeded full-width Qwen2-0.5B params in fp32, each leaf
    viewed [4, numel / 4], in the floating_point (f = 1, 2), gf256 (f = 1,
    2) and xor (f = 1) modes, shards lost and recovered: gf256 and xor bit
    for bit, floating_point within 1e-5 of max |leaf|.  ``device`` and
    ``smoke`` rehearse it on the CPU (n = 96, the smoke config)."""
    import numpy as np
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.core.context import FTContext
    from repro_torch.models import transformer as tf
    from repro_torch.solvers import RedundantSubspaceCG, SolverConfig
    from repro_torch.tree import tree_leaves, tree_map

    out = {"card": card}
    cfg = SolverConfig(n=96 if smoke else SOLVER_N)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def solve(on_iteration=None):
        sync()
        t0 = time.perf_counter()
        s = RedundantSubspaceCG(cfg, device=device)
        sync()
        t1 = time.perf_counter()
        rep = s.run(on_iteration=on_iteration)
        sync()
        t2 = time.perf_counter()
        return s, rep, dict(setup_s=t1 - t0, solve_s=t2 - t1,
                            ms_per_iter=1e3 * (t2 - t1) / rep.iterations,
                            iterations=rep.iterations)

    # (a) clean
    s, rep, walls = solve()
    if not rep.converged or rep.trips or rep.failovers or rep.reweights:
        raise AssertionError(f"clean solve: {rep}")
    x_true = torch.from_numpy(np.random.RandomState(cfg.seed).standard_normal(
        cfg.n)).to(device)
    err_x = float((s.x - x_true).abs().max())
    err_ax = float((s.a @ s.x - s.b).abs().max())
    if not (err_x <= SOLVER_TOL_X and err_ax <= SOLVER_TOL_X):
        raise AssertionError(f"clean solve: max |x - x_true| {err_x:.3g}, "
                             f"max |A x - b| {err_ax:.3g}")
    held = s.nbytes()
    log("solver", f"clean n={cfg.n}: converged in {rep.iterations} "
                  f"iterations, 0 trips; setup {walls['setup_s']:.3f} s, "
                  f"solve {walls['solve_s']:.3f} s "
                  f"({walls['ms_per_iter']:.3f} ms an iteration, "
                  f"synchronized); {held / 1e9:.3f} GB held on the device; "
                  f"max |x - x_true| {err_x:.3g}, max |A x - b| "
                  f"{err_ax:.3g} [{card}]")
    out["clean"] = dict(walls, bytes_held=held, err_x=err_x, err_ax=err_ax,
                        residual=rep.residual_norm)
    x_clean = s.x.clone()
    del s

    # (b) drilled
    fired = {}

    def hook(sv):
        if sv.iteration == 2:
            sv.inject_correction_sdc(3, 0, index=1, delta=1e3)
        if sv.iteration == 3:
            idx = int(sv.x.abs().argmax())
            bit = 62 if abs(float(sv.x[idx])) < 2.0 else 61
            fired["flip"] = (idx, bit, sv.corrupt_iterate(idx, bit=bit))
            fired["pod"] = sv.lose_pod(1)["killed"]

    d, drep, dwalls = solve(hook)
    kinds = [t.kind for t in drep.trips]
    if not drep.converged or "replica_repair" not in kinds or \
            "guard_restart" not in kinds or not drep.failovers:
        raise AssertionError(f"drilled solve: {drep}")
    diff = float((d.x - x_clean).abs().max())
    if diff > SOLVER_TOL_X:
        raise AssertionError(f"drilled solve: max |x - x_clean| {diff:.3g}")
    extra = drep.iterations - rep.iterations
    log("solver", f"drilled: SDC s3r0 at iteration 2, x[{fired['flip'][0]}] "
                  f"bit {fired['flip'][1]} -> {fired['flip'][2]:.3e} and pod "
                  f"1 lost ({len(fired['pod'])} workers) at iteration 3: "
                  f"trips {kinds}, {len(drep.failovers)} failovers; "
                  f"converged in {drep.iterations} iterations (+{extra}), "
                  f"{dwalls['ms_per_iter']:.3f} ms an iteration; max |x - "
                  f"x_clean| {diff:.3g} [{card}]")
    out["drilled"] = dict(dwalls, trips=kinds, failovers=len(drep.failovers),
                          extra_iterations=extra, max_diff=diff)
    del d, x_clean
    if device == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()

    # (c) the FT context over the full-width params
    mcfg = dataclasses.replace(
        smoke_config("qwen2-0.5b") if smoke else get_config("qwen2-0.5b"),
        dtype="float32")
    params = tf.init_params(torch.Generator(device=device).manual_seed(0),
                            mcfg)
    leaves = tree_leaves(params)
    if any(x.numel() % 4 for x in leaves):
        raise AssertionError("a leaf's size is not a multiple of 4")
    views = tree_map(lambda x: x.reshape(4, -1), params)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    out["context"] = {"param_bytes": nbytes, "leaves": len(leaves)}
    for mode, f in CTX_MODES:
        lost = CTX_LOST[f]
        ctx = FTContext(4, f=f)
        sync()
        t0 = time.perf_counter()
        ctx.register("params", views, mode=mode)
        sync()
        t1 = time.perf_counter()
        ctx.fail(lost)
        sync()
        t2 = time.perf_counter()
        ctx.recover(lost)
        sync()
        t3 = time.perf_counter()
        worst = 0.0
        for got, want in zip(tree_leaves(ctx.get("params")),
                             tree_leaves(views)):
            if mode == "floating_point":
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                worst = max(worst, err / scale if scale else err)
            elif not torch.equal(got.view(torch.int32),
                                 want.view(torch.int32)):
                raise AssertionError(f"{mode} f={f}: not bit for bit")
        if worst > CTX_RTOL:
            raise AssertionError(f"{mode} f={f}: recovery error {worst:.3g} "
                                 f"of max |leaf|")
        key = f"{mode}_f{f}"
        out["context"][key] = dict(register_s=t1 - t0, fail_s=t2 - t1,
                                   recover_s=t3 - t2, rel_err=worst)
        log("solver", f"FTContext(p=4, f={f}) {mode}: {len(leaves)} leaves, "
                      f"{nbytes / 1e9:.3f} GB; register {t1 - t0:.3f} s, "
                      f"recover shards {lost} {t3 - t2:.3f} s; "
                      + ("bit for bit" if mode != "floating_point" else
                         f"max error {worst:.3g} of max |leaf|")
                      + f" [{card}]")
        del ctx
    record["solver"] = out
    del params, views
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# Phase 16: the LM's other families.  Kernel #1 launches of one forward
# pass: the protected projections of each block kind (the MoE experts and
# router, mamba's x_proj, the xLSTM gates, the Whisper encoder and the
# decode-time cross attention over cached K/V run unprotected, as in the
# reference), plus the untied head.
MIXER_PROJ = {"attn": 4, "attn_local": 4, "attn_bidir": 4, "cross": 4,
              "dec": 8, "mamba": 2, "mlstm": 4, "slstm": 3}
FFN_PROJ = {"dense": 3, "moe": 0, "none": 0}
HBM_BPS = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
FAMILY_PROMPTS = (16, 129)  # prompt lengths drawn from [16, 128]


def protected_per_pass(cfg, *, decode=False, stash=False):
    """Kernel #1 launches of one forward pass of ``cfg``: ``decode`` for a
    one-token step over a cache (a dec block's cross attention reads the
    cached K/V, unprotected), ``stash`` for a prefill that also projects
    the cross K/V into the cache."""
    n = 0
    for pattern, repeats in cfg.layout:
        for mixer, ffn in pattern:
            m = MIXER_PROJ[mixer]
            if mixer == "dec":
                m = 4 if decode else 8 + (2 if stash else 0)
            n += repeats * (m + FFN_PROJ[ffn])
    return n + (0 if cfg.tie_embeddings else 1)


def _free(torch, device):
    import gc
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _gb(torch, device, peak=True):
    if device != "cuda":
        return float("nan")
    return (torch.cuda.max_memory_allocated() if peak
            else torch.cuda.memory_allocated()) / 1e9


def _counts(kmm, device):
    """(kernel launches, plain-version calls); on the CPU the kernel's
    plain version stands in for its launches."""
    if device == "cuda":
        return kmm.launches, kmm.plain_calls
    return kmm.plain_calls, 0


def _teacher_forced(torch, tf, engine, req, abft):
    """Full-forward logits over the prompt and the request's tokens but the
    last, at the positions that chose each token: [gen, V]."""
    seq = list(req.prompt) + list(req.output[:-1])
    tok = torch.tensor([seq], device=engine.device)
    with torch.no_grad():
        logits = tf.forward(engine.params, tok, engine.cfg, abft=abft)[0][0]
    return logits[len(req.prompt) - 1:].float()


def _greedy_check(torch, tf, engine, req, plain_abft):
    """The request's tokens against greedy decoding by the full forward, on
    the served (kernel) path: the full forward over the prompt and the
    emitted tokens must choose each emitted token (then free-running greedy
    decoding gives the same tokens).  A token that is not the argmax passes
    only as a near tie: within 2 x noise of the max, noise = max |kernel -
    plain| of the same logits (the plain path recomputes them).  This
    checks the engine against the forward; kernel #1 itself is held to its
    plain version on the run's operands (`_serve_family`)."""
    lk = _teacher_forced(torch, tf, engine, req, engine.abft)
    lp = _teacher_forced(torch, tf, engine, req, plain_abft)
    noise = float((lk - lp).abs().max())
    out = torch.tensor(req.output, device=lk.device)
    chosen = lk.gather(1, out[:, None])[:, 0]
    short = (lk.max(dim=1).values - chosen).tolist()
    exact = [i for i, d in enumerate(short) if d == 0.0]
    row = dict(rid=req.rid, plen=len(req.prompt), gen=len(req.output),
               exact=len(exact), noise=noise, worst_short=max(short),
               tokens=list(req.output))
    if len(exact) < len(short) and max(short) > 2 * noise:
        raise AssertionError(f"request {req.rid}: tokens leave greedy "
                             f"full-forward decoding: {row}")
    return row


def _serve_family(torch, record, key, arch, *, device, smoke, lens, gen,
                  slots, kernel_dtype, layers=None, dtype=None, check=None):
    """Serve one family through repro_torch.launch.serve.run with ABFT
    verify; kernel #1's launches and plain calls counted from the warm-up
    on; prefill and decode-step walls (the engine synchronizes both); then
    kernel #1 held against its plain version on the operands of its first
    call at each shape and tile of the run (`hold_oneshot`, outside the
    counted run)."""
    from repro_torch.core.abft_gemm import ABFTConfig
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.launch.serve import run
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves_with_path as leaves

    counts = {}

    def on_warm(engine):
        kmm.reset_counts()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        counts["t0"] = time.perf_counter()

    _free(torch, device)
    t0 = time.perf_counter()
    captured = {}
    with _capture_oneshot(kmm, captured):
        finished, engine = run(
            arch, smoke=smoke, requests=len(lens), slots=slots,
            prompt_lens=list(lens), gen=gen, abft_mode="verify",
            abft_backend="auto" if device == "cuda" else "cuda",
            kernel_dtype=kernel_dtype, layers=layers, dtype=dtype,
            device=device, on_warm=on_warm, verbose=False)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - counts["t0"]
    launches, other = _counts(kmm, device)
    cfg, st = engine.cfg, engine.stats
    per_prefill = protected_per_pass(cfg)
    per_step = protected_per_pass(cfg, decode=True)
    want = per_prefill * st.prefills + per_step * st.decode_steps
    if len(finished) != len(lens) or any(len(r.output) != gen
                                         for r in finished):
        raise AssertionError(f"{arch}: not every request finished with "
                             f"{gen} tokens")
    if launches != want or other != 0:
        raise AssertionError(f"{arch}: kernel launches {launches} != {want}"
                             f" or plain calls {other} != 0")
    # the engine's own copies (encoded weights, the tied table in fp32)
    # are not params
    n_params = sum(x.numel() for path, x in leaves(engine.params)
                   if path[-1] not in ("w_enc", "table_f32"))
    enc_gb = sum(x.numel() * x.element_size()
                 for path, x in leaves(engine.params)
                 if path[-1] == "w_enc") / 1e9
    row = dict(arch=arch, layers=cfg.n_layers, layout=repr(cfg.layout),
               d_model=cfg.d_model, dtype=cfg.dtype,
               kernel_dtype=kernel_dtype, params_b=n_params / 1e9,
               w_enc_gb=enc_gb, prompt_lens=list(lens), gen=gen, slots=slots,
               prefills=st.prefills, decode_steps=st.decode_steps,
               launches=launches, per_prefill=per_prefill,
               per_step=per_step, plain_calls=other,
               prefill_ms=1e3 * st.prefill_s / max(st.prefills, 1),
               decode_step_ms=1e3 * st.clean_step_mean_s(),
               decode_step_ms_median=1e3 * _median(st.decode_step_s),
               wall_s=wall, setup_s=counts["t0"] - t0,
               peak_gb=_gb(torch, device), max_len=engine.max_len)
    log("families", f"{arch}: {cfg.n_layers} layers at d_model "
                    f"{cfg.d_model}, {n_params / 1e9:.2f} B params in "
                    f"{cfg.dtype} + {enc_gb:.2f} GB w_enc; "
                    f"{len(finished)} requests, {st.prefills} prefills, "
                    f"{st.decode_steps} decode steps; kernel #1 launches "
                    f"{launches} = {per_prefill} x {st.prefills} + "
                    f"{per_step} x {st.decode_steps}, plain 0")
    log("families", f"{arch}: prefill {row['prefill_ms']:.2f} ms mean, "
                    f"decode step {row['decode_step_ms']:.2f} ms mean "
                    f"({row['decode_step_ms_median']:.2f} median), peak "
                    f"memory {row['peak_gb']:.2f} GB, serve wall "
                    f"{wall:.1f} s, set-up {row['setup_s']:.1f} s")
    held = []
    for args, kw in captured.values():
        errs = hold_oneshot(torch, kmm, args, kw,
                            kmm.abft_matmul_cuda(*args, **kw))
        held.append(dict(m=args[0].shape[0], k=args[0].shape[1],
                         n=args[1].shape[1], dtype=str(args[0].dtype),
                         tile=[kw["bm"], kw["bn"]], splits=kw.get("splits"),
                         max_abs_err=errs[0], err_cs_col=errs[1],
                         err_cs_row=errs[2]))
    del captured
    ms = sorted({h["m"] for h in held})
    prefill_ms = {engine._prefill_len(n) for n in lens}
    if slots not in ms or not prefill_ms <= set(ms):
        raise AssertionError(f"{arch}: kernel #1 operands captured at m "
                             f"{ms}, not at decode's {slots} and every "
                             f"prefill's {sorted(prefill_ms)}")
    row.update(kernel_held=held,
               held_max_abs_err=max(h["max_abs_err"] for h in held))
    log("families", f"{arch}: kernel #1 held against its plain version on "
                    f"the operands of {len(held)} shapes and tiles of this "
                    f"run (m in {ms}; k, n of every projection): c, checksum "
                    f"columns and residuals within RTOL {RTOL:g}, max |c - "
                    f"plain| {row['held_max_abs_err']:.3g}")
    plain = ABFTConfig(mode="verify", backend="ref",
                       in_dtype=kernel_dtype)
    if check is not None:
        row.update(check(engine, finished, plain))
    record.setdefault("families", {})[key] = row
    return engine, finished, launches


class _Fp32Params(dict):
    """A bf16 param tree seen in fp32, one layer at a time: the top-level
    leaves are cast at once, each layout group's layers as the forward
    reaches them (so an fp32 forward fits beside the bf16 weights)."""

    def __init__(self, params):
        super().__init__({k: _to_fp32(v) for k, v in params.items()
                          if k != "groups"})
        self["groups"] = [_Fp32Layers(g) for g in params["groups"]]


class _Fp32Layers:
    def __init__(self, layers):
        self.layers = layers

    def __len__(self):
        return len(self.layers)

    def __iter__(self):
        for layer in self.layers:
            yield _to_fp32(layer)


def _lens(n, seed, lo_hi=FAMILY_PROMPTS, odd=False):
    import numpy as np
    rs = np.random.RandomState(seed)
    lens = rs.randint(*lo_hi, size=n).tolist()
    if odd:   # no power of two: the padding repair is what is on trial
        lens = [x + 1 if x & (x - 1) == 0 else x for x in lens]
    return lens


def phase_families(torch, record, card, device="cuda", smoke=False):
    """The LM's other families through the port's serving entry point and
    its forward, ABFT verify on kernel #1: (a) Qwen3-30B-A3B (MoE, 128
    experts top-8) at full width and depth in bf16, 8 requests of 16-128
    prompt tokens, each prefill's first token the argmax of the kernel
    path's logits and of the plain path's (where its top two are no near
    tie); (b) Jamba-1.5-Large's period cut
    to its first four blocks (mamba, attention, dense and MoE FFNs) at
    d_model 8192 in bf16, prompts of 37, 77, 100 and 123 tokens, one
    request's tokens held to greedy decoding by the full forward (the
    padding repair on the card); (c) xLSTM-350M whole in fp32, 8 requests,
    the same greedy check; (d) Whisper-large-v3 whole in fp32 (a forward of
    2 x 64 tokens over 1500 seeded frames, verify against off; a prefill of
    8 tokens and 8 decode steps over the cached cross K/V against the full
    forward) and Llama-3.2-Vision-11B whole in bf16 (a forward over 1024
    seeded image embeddings, verify against off).  Launch counts from the
    block kinds (`protected_per_pass`), no plain call.  ``device`` and
    ``smoke`` rehearse it on the CPU.  Kernel #1 is held to its plain
    version on the operands of (a)-(c).  Returns kernel #1's launches and
    the largest |c - plain| of those holds."""
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves_with_path

    t_phase = time.perf_counter()
    total = 0
    held_err = 0.0
    _free(torch, device)
    log("families", f"memory held before the phase: "
                    f"{_gb(torch, device, peak=False):.2f} GB")

    # (a) MoE: each prompt's prefill again, as phase 5 does it: the kernel
    # path as served, the plain path (backend "ref", bf16 operands), and a
    # control with the params cast to fp32 one layer at a time (61 GB of
    # bf16 weights have no room for an fp32 copy) and fp32 activations,
    # whose protected projections still take bf16 operands (the plain
    # path's in_dtype casts x and w_enc; fp32 accumulation): noise = max
    # |plain - control| measures the bf16 activations and the unprotected
    # arithmetic (experts, router, attention, norms), not the projections'
    # products.  The kernel path must lie within 2 x noise of the plain one
    # (phase 5's tolerance).  The first token must be the kernel path's
    # argmax, and the plain path's argmax unless the plain path's top two
    # logits lie within 2 x noise (a near tie): then its plain logit must
    # lie within 2 x noise of the plain maximum.  (Two bf16 paths that sum
    # in another order, with the routing of 128 experts between them, can
    # choose two tokens a few bf16 ulps apart: on the card one prompt of
    # eight did, 0.2 apart at |logit| 4.7.)
    def first_tokens(engine, finished, plain):
        rows = []
        cfg32 = dataclasses.replace(engine.cfg, dtype="float32")
        p32 = _Fp32Params(engine.params)
        with torch.no_grad():
            for req in sorted(finished, key=lambda r: r.rid):
                # the prompt as the engine prefilled it: padded to its
                # bucket, the first token read at position plen - 1
                plen = len(req.prompt)
                tok = torch.zeros((1, engine._prefill_len(plen)),
                                  dtype=torch.int64, device=engine.device)
                tok[0, :plen] = torch.tensor(req.prompt)

                def prefill(params, c, abft):
                    cache = tf.init_cache(c, 1, engine.max_len,
                                          device=engine.device)
                    return tf.forward(params, tok, c, cache=cache,
                                      abft=abft)[0][0, plen - 1].float()

                lk = prefill(engine.params, engine.cfg, engine.abft)
                lp = prefill(engine.params, engine.cfg, plain)
                l32 = prefill(p32, cfg32, plain)
                gap = float((lk - lp).abs().max())
                noise = float((lp - l32).abs().max())
                first = req.output[0]
                top2 = lp.topk(2).values
                rows.append(dict(
                    rid=req.rid, plen=plen, gap=gap, tol=2 * noise,
                    noise=noise, max_abs_logit=float(lp.abs().max()),
                    first=first, kernel_argmax=int(lk.argmax()),
                    plain_argmax=int(lp.argmax()),
                    fp32_argmax=int(l32.argmax()),
                    plain_margin=float(top2[0] - top2[1]),
                    near_tie=float(top2[0] - top2[1]) <= 2 * noise,
                    plain_short=float(lp.max() - lp[first])))
        bad = [r for r in rows
               if r["gap"] > r["tol"] or r["first"] != r["kernel_argmax"]
               or (r["first"] != r["plain_argmax"] and not r["near_tie"])
               or r["plain_short"] > r["tol"]]
        worst = max(rows, key=lambda r: r["gap"] / (r["tol"] or 1.0))
        agree = sum(r["first"] == r["plain_argmax"] for r in rows)
        own = sum(r["first"] == r["kernel_argmax"] for r in rows)
        ties = sum(r["near_tie"] for r in rows)
        log("families", f"qwen3-moe-30b-a3b: first tokens the kernel "
                        f"path's argmax {own}/{len(rows)}, the plain "
                        f"path's {agree}/{len(rows)} ({ties} near ties, "
                        f"the rest held outright), the control's "
                        f"{sum(r['first'] == r['fp32_argmax'] for r in rows)}"
                        f"/{len(rows)}; worst |kernel - plain| / tolerance "
                        f"{worst['gap']:.4g} / {worst['tol']:.4g} (max "
                        f"|logit| {worst['max_abs_logit']:.4g})")
        for r in rows:
            log("families", "prefill check " + json.dumps(r))
        if bad:
            raise AssertionError(f"prefill checks failed: {bad}")
        return {"prefill_checks": rows}

    engine, finished, n = _serve_family(
        torch, record, "qwen3", "qwen3-moe-30b-a3b", device=device,
        smoke=smoke, lens=_lens(8, 16), gen=16, slots=4,
        kernel_dtype="bf16", check=first_tokens)
    total += n
    held_err = max(held_err, record["families"]["qwen3"]["held_max_abs_err"])
    cfg = engine.cfg
    expert_bytes = sum(
        x.numel() * x.element_size()
        for path, x in tree_leaves_with_path(engine.params)
        if "moe" in path and path[-1] in ("gate", "up", "down"))
    floor_ms = 1e3 * expert_bytes / HBM_BPS
    record["families"]["qwen3"].update(expert_gb=expert_bytes / 1e9,
                                       decode_floor_ms=floor_ms)
    log("families", f"qwen3-moe-30b-a3b: a decode step reads all "
                    f"{cfg.n_experts} experts' {expert_bytes / 1e9:.2f} GB "
                    f"(dropless buffer): floor {floor_ms:.2f} ms at 3.35 TB/s"
                    f"; measured {record['families']['qwen3']['decode_step_ms']:.2f} ms")
    del engine, finished

    # (b) Jamba's period, (c) xLSTM: the greedy full-forward check
    def greedy(engine, finished, plain):
        req = min(finished, key=lambda r: r.rid)
        row = _greedy_check(torch, tf, engine, req, plain)
        log("families", f"{engine.cfg.name}: request {req.rid} "
                        f"({row['plen']} prompt tokens): {row['exact']}/"
                        f"{row['gen']} tokens the full forward's argmax, "
                        f"worst shortfall {row['worst_short']:.4g} "
                        f"(tolerance 2 x noise = {2 * row['noise']:.4g})")
        return {"greedy_check": row}

    for key, arch, kw in (
            ("jamba", "jamba-1.5-large-398b",
             dict(lens=[37, 77, 100, 123], slots=4, kernel_dtype="bf16",
                  layers=4)),
            ("xlstm", "xlstm-350m",
             dict(lens=_lens(8, 17, odd=True), slots=4,
                  kernel_dtype="fp32", dtype="float32"))):
        engine, finished, n = _serve_family(
            torch, record, key, arch, device=device, smoke=smoke, gen=16,
            check=greedy, **kw)
        total += n
        held_err = max(held_err, record["families"][key]["held_max_abs_err"])
        del engine, finished

    # (d) Whisper and the vision config, forward and decode
    total += _whisper(torch, record, device, smoke)
    total += _vision(torch, record, device, smoke)
    secs = time.perf_counter() - t_phase
    record["families"]["seconds"] = secs
    record["families"]["launches"] = total
    log("families", f"phase 16: kernel #1 launches {total}, plain 0, "
                    f"{secs:.1f} s ({card})")
    return total, held_err


def _verify_vs_off(torch, tf, params, cfg, tok, kw, device, kmm):
    """ABFT verify (kernel #1) against off on one forward, inside phase 5's
    tolerance: 2 x noise, noise = the off path's distance from the same
    forward at another precision (fp32 copies of bf16 params; TF32
    products for fp32 params)."""
    from repro_torch.core.abft_gemm import ABFTConfig
    abft = ABFTConfig(mode="verify",
                      backend="auto" if device == "cuda" else "cuda",
                      in_dtype="bf16" if cfg.dtype == "bfloat16" else "fp32")
    with torch.no_grad():
        kmm.reset_counts()
        lv = tf.forward(params, tok, cfg, abft=abft, **kw)[0].float()
        launches, other = _counts(kmm, device)
        lo = tf.forward(params, tok, cfg, **kw)[0].float()
        if cfg.dtype == "bfloat16":
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            p32 = _to_fp32(params)
            kw32 = {k: v.float() for k, v in kw.items()}
            l_alt = tf.forward(p32, tok, cfg32, **kw32)[0].float()
            del p32
            alt = "fp32 copy"
        else:
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = device == "cuda"
            try:
                l_alt = tf.forward(params, tok, cfg, **kw)[0].float()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
            alt = "TF32 products"
    gap = float((lv - lo).abs().max())
    noise = float((lo - l_alt).abs().max())
    want = protected_per_pass(cfg)
    if launches != want or other != 0:
        raise AssertionError(f"{cfg.name}: kernel launches {launches} != "
                             f"{want} or plain calls {other} != 0")
    if device == "cuda" and gap > 2 * noise:
        raise AssertionError(f"{cfg.name}: verify against off {gap} > 2 x "
                             f"{noise} ({alt})")
    return dict(gap=gap, noise=noise, noise_from=alt, launches=launches,
                max_abs_logit=float(lo.abs().max())), lv, abft


def _whisper(torch, record, device, smoke):
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    _free(torch, device)
    name = "whisper-large-v3"
    cfg = dataclasses.replace(
        smoke_config(name) if smoke else get_config(name), dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = tf.init_params(gen, cfg)
    b, s, sp = 2, 64, 8
    frames = torch.randn((b, cfg.n_frames, cfg.d_model), generator=gen,
                         device=device)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device=device)
    row, full, abft = _verify_vs_off(torch, tf, params, cfg, tok,
                                     {"frames": frames}, device, kmm)
    # prefill sp tokens (the cross K/V stashed), then decode over the cache
    s_dec = 2 * sp
    kmm.reset_counts()
    with torch.no_grad():
        cache = tf.init_cache(cfg, b, s_dec, device=device)
        pre, cache, _ = tf.forward(params, tok[:, :sp], cfg, cache=cache,
                                   frames=frames, abft=abft)
        errs = [float((pre[:, -1] - full[:, sp - 1]).abs().max())]
        for i in range(sp, s_dec):
            logit, cache = tf.decode_step(params, tok[:, i:i + 1],
                                          torch.tensor(i, device=device),
                                          cache, cfg, abft=abft)
            errs.append(float((logit - full[:, i]).abs().max()))
    if device == "cuda":
        torch.cuda.synchronize()
    launches, other = _counts(kmm, device)
    want = protected_per_pass(cfg, stash=True) + \
        (s_dec - sp) * protected_per_pass(cfg, decode=True)
    scale = float(full.abs().max()) + 1.0
    if launches != want or other != 0:
        raise AssertionError(f"whisper decode: kernel launches {launches} != "
                             f"{want} or plain calls {other} != 0")
    if max(errs) >= 2e-3 * scale:
        raise AssertionError(f"whisper decode leaves the forward: {errs} "
                             f"(scale {scale})")
    n_params = sum(x.numel() for x in tree_leaves(params))
    row.update(arch=name, params_b=n_params / 1e9, frames=cfg.n_frames,
               tokens=[b, s], decode_max_err=max(errs), decode_scale=scale,
               decode_launches=launches, wall_s=time.perf_counter() - t0,
               peak_gb=_gb(torch, device))
    log("families", f"{name}: {n_params / 1e9:.2f} B params fp32, forward "
                    f"of {b} x {s} tokens over {cfg.n_frames} frames: "
                    f"|verify - off| {row['gap']:.4g} <= 2 x noise = "
                    f"{2 * row['noise']:.4g} ({row['noise_from']}), kernel #1 "
                    f"launches {row['launches']}; prefill {sp} + decode "
                    f"{s_dec - sp} over the cached cross K/V: max err "
                    f"{max(errs):.4g} < 2e-3 x {scale:.4g}, launches "
                    f"{launches}; peak {row['peak_gb']:.2f} GB, "
                    f"{row['wall_s']:.1f} s")
    record.setdefault("families", {})["whisper"] = row
    return row["launches"] + launches


def _vision(torch, record, device, smoke):
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    _free(torch, device)
    name = "llama-3.2-vision-11b"
    cfg = smoke_config(name) if smoke else get_config(name)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = tf.init_params(gen, cfg)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    img = torch.randn((1, cfg.n_img_tokens, cfg.d_model), generator=gen,
                      device=device).to(dt)
    tok = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                        device=device)
    row, _, _ = _verify_vs_off(torch, tf, params, cfg, tok,
                               {"img_emb": img}, device, kmm)
    n_params = sum(x.numel() for x in tree_leaves(params))
    row.update(arch=name, params_b=n_params / 1e9,
               img_tokens=cfg.n_img_tokens, tokens=[1, 64],
               wall_s=time.perf_counter() - t0, peak_gb=_gb(torch, device))
    log("families", f"{name}: {n_params / 1e9:.2f} B params {cfg.dtype}, "
                    f"forward of 64 tokens over {cfg.n_img_tokens} image "
                    f"embeddings: |verify - off| {row['gap']:.4g} <= 2 x "
                    f"noise = {2 * row['noise']:.4g} ({row['noise_from']}), kernel "
                    f"#1 launches {row['launches']}; peak "
                    f"{row['peak_gb']:.2f} GB, {row['wall_s']:.1f} s")
    record.setdefault("families", {})["vision"] = row
    del params
    _free(torch, device)
    return row["launches"]


# phase 17: elastic pods at full width
ELASTIC_A = dict(mesh_shape=(2, 2, 2), steps=10, kill_pod_at=4, regrow_at=8,
                 diskless_every=1, disk_every=3, keep=2, f=1)
ELASTIC_B = dict(mesh_shape=(2, 1, 1), steps=5, kill_pod_at=2, regrow_at=None,
                 diskless_every=2, disk_every=10, f=1)


def _capture_encodes(seen):
    """Wrap `DisklessCheckpoint.encode` to count the leaves each encode
    hands kernel #3 and keep the first stacked state encoded at p = 4 and
    p = 2; returns the function that unwraps it."""
    from repro_torch.ckpt.diskless import DisklessCheckpoint
    from repro_torch.tree import tree_leaves
    enc = DisklessCheckpoint.encode

    def encode(self, state, *a, **kw):
        seen["encodes"] += 1
        seen["leaves"] += sum(1 for x in tree_leaves(state)
                              if self._encoded(x))
        if self.p in (2, 4):
            seen["by_p"].setdefault(self.p, state)
        return enc(self, state, *a, **kw)

    DisklessCheckpoint.encode = encode

    def undo():
        DisklessCheckpoint.encode = enc
    return undo


def _dp_walls(rep):
    """Median step wall (s) at each DP extent of one drill, in the order
    the steps ran (the first step of each stretch dropped)."""
    a = rep["kill_pod_at"]
    r = rep["rollback_step"]
    g = rep["regrow_at"] if rep["regrow_at"] is not None else rep["steps"]
    walls = rep["walls"]["steps"]
    full = walls[:a] + walls[a + g - r:]
    surv = walls[a:a + g - r]
    return {"full": _median(full[1:]), "survivor": _median(surv[1:])}


def phase_elastic(torch, record, card, device="cuda", smoke=False):
    """The pod-loss drill through repro_torch.launch.train.run_elastic_drill
    on Qwen2-0.5B at full width in fp32 (batch 16 x seq 128): (a) rung 3b
    on the logical (2, 2, 2) mesh and (b) rung 3a on (2, 1, 1), kernel #3
    for every encode at p = the DP extent (counts zeroed just before (a),
    read after (b)); (c) kernel #3 against its plain version on the p = 4
    and p = 2 states the drills encoded, with its times per whole-state
    encode; (d) the transitions' costs, the step wall at each DP extent
    and peak memory."""
    import tempfile

    from repro_torch.ckpt.diskless import encode_view
    from repro_torch.core.checksum import checkpoint_matrix
    from repro_torch.kernels import checksum_encode as kenc
    from repro_torch.launch.train import run_elastic_drill
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    size = dict(batch=8, seq=16) if smoke else dict(batch=16, seq=128)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    saves = []
    seen = dict(encodes=0, leaves=0, by_p={})
    undo = _capture_encodes(seen)
    (ROOT / "build").mkdir(exist_ok=True)
    reps = {}
    try:
        kenc.reset_counts()
        for key, kw in (("a", ELASTIC_A), ("b", ELASTIC_B)):
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    reps[key] = run_elastic_drill(
                        "qwen2-0.5b", lr=1e-3, ckpt_dir=d, smoke=smoke,
                        dtype="float32", device=device, verbose=False,
                        **size, **kw)
                reps[key]["phase_wall_s"] = time.perf_counter() - t0
            saves.append(reps[key]["walls"]["save"])
        launches, plain = kenc.launches, kenc.plain_calls
    finally:
        undo()
    a, b = reps["a"], reps["b"]
    pa, pb = a["parity"], b["parity"]
    if not (a["shrink"]["restore_path"] == "disk"
            and pa["params_bitwise_equal"] is True
            and pa["max_abs_loss_diff"] == 0.0
            and pa["steps_compared"] >= 3
            and a["shrink"]["n_respecced"] > 0
            and a["regrow"]["reused_executable"] is True
            and a["regrow"]["gen_to"] == 2
            and a["regrow"]["rollback_step"] is None
            and a["recoveries"]["elastic"] == 2):
        raise AssertionError(f"(a) rung 3b drill: parity {pa}, shrink "
                             f"{a['shrink']}, regrow {a['regrow']}, "
                             f"recoveries {a['recoveries']}")
    if not (b["shrink"]["restore_path"] == "diskless"
            and pb["steps_compared"] >= 3
            and pb["params_max_abs_diff"] < 1e-4
            and pb["max_abs_loss_diff"] < 1e-3
            and b["recoveries"]["elastic"] == 1):
        raise AssertionError(f"(b) rung 3a drill: parity {pb}, shrink "
                             f"{b['shrink']}")
    if not all(math.isfinite(v) for r in (a, b)
               for v in r["losses"].values()):
        raise AssertionError("a drill's loss is not finite")
    # one launch per encoded leaf of every encode (the re-keys included)
    want = (seen["leaves"], 0) if cuda else (0, seen["leaves"])
    if (launches, plain) != want or sorted(seen["by_p"]) != [2, 4]:
        raise AssertionError(f"kernel #3: {launches} launches, {plain} "
                             f"plain calls over {seen['encodes']} encodes of "
                             f"{seen['leaves']} leaves, p {sorted(seen['by_p'])}")
    n_saves = [len(x) for x in saves]
    if n_saves[0] > 5:
        raise AssertionError(f"(a) wrote {n_saves[0]} disk saves")
    for key, r in reps.items():
        log("elastic", f"({key}) mesh {tuple(r['mesh'])}: shrink "
                       f"{json.dumps(r['shrink'])}")
        if r["regrow"]:
            log("elastic", f"({key}) regrow {json.dumps(r['regrow'])}")
        log("elastic", f"({key}) parity {json.dumps(r['parity'])}; "
                       f"recoveries {r['recoveries']}; losses "
                       f"{list(r['losses'].values())}; "
                       f"{len(r['walls']['save'])} disk saves, host copy "
                       f"walls {[round(x, 3) for x in r['walls']['save']]} "
                       f"s; drill {r['phase_wall_s']:.2f} s")

    # (c) kernel #3 against its plain version on the states the drills
    # encoded, one whole-state encode summed over its launches
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=device) \
        if cuda else None
    enc = {}
    for p in (4, 2):
        a_m = checkpoint_matrix(1, p, device=device)
        tot = dict(p=p, leaves=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                   library_ms=0.0, bound_ms=0.0, gbytes=0.0,
                   bound_by="bytes")
        for x in tree_leaves(seen["by_p"][p]):
            if not (x.is_floating_point() and x.dim() >= 1
                    and x.shape[0] == p):
                continue
            v = encode_view(x, p)
            if cuda:
                got = kenc.checksum_encode_cuda(v, a_m)
            else:
                got = kenc.checksum_encode_plain(v, a_m)
            want_ = kenc.checksum_encode_plain(v, a_m)
            terms = torch.matmul(a_m.abs(), v.reshape(p, -1).float().abs()) \
                .reshape(want_.shape)
            diff = (got.float() - want_.float()).abs()
            if not bool((diff <= 4 * p * 2.0 ** -24 * terms).all()):
                raise AssertionError(f"kernel #3 at p = {p}: kernel and "
                                     f"plain differ by {float(diff.max())}")
            tot["max_abs_err"] = max(tot["max_abs_err"], float(diff.max()))
            tot["leaves"] += 1
            del got, want_, terms, diff
            if cuda:
                ms, plain_ms, lib_ms = enc_times(torch, v, a_m, flush, 3)
                tot["ms"] += ms
                tot["plain_ms"] += plain_ms
                tot["library_ms"] += lib_ms
            p_, m_, n_ = v.shape
            b_ms, b_by = enc_bound(p_, 1, m_, n_, x.element_size())
            if b_by != "bytes":
                tot["bound_by"] = "bytes and operations"
            tot["bound_ms"] += b_ms
            tot["gbytes"] += (p_ + 1) * m_ * n_ * x.element_size() / 1e9
        enc[p] = tot
        log("elastic", f"(c) kernel #3 at p = {p}: " + json.dumps(tot))
    seen["by_p"].clear()

    # (d) every other cost
    walls = {k: _dp_walls(r) for k, r in reps.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    log("elastic", f"(d) median step wall (s) at DP 4 / DP 2 (a): "
                   f"{walls['a']['full']:.4f} / {walls['a']['survivor']:.4f};"
                   f" at DP 2 / DP 1 (b): {walls['b']['full']:.4f} / "
                   f"{walls['b']['survivor']:.4f}; reshard walls (s) "
                   f"{[r['shrink']['reshard_wall_s'] for r in reps.values()]}"
                   f" shrink, {a['regrow']['reshard_wall_s']:.4f} re-grow; "
                   f"build walls (s) {a['shrink']['build_s']:.4f}; peak "
                   f"{peak if peak is None else round(peak, 2)} GB; kernel "
                   f"#3 {launches} launches over {seen['encodes']} encodes; "
                   f"phase {time.perf_counter() - t_phase:.1f} s; {card}")
    record["elastic"] = dict(
        a={k: v for k, v in a.items() if k != "walls"},
        b={k: v for k, v in b.items() if k != "walls"},
        step_walls=walls, saves=saves, encode=enc, peak_gb=peak,
        launches=launches, encodes=seen["encodes"],
        phase_s=time.perf_counter() - t_phase, card=card)
    if cuda:
        del flush
        torch.cuda.empty_cache()
    return launches

TUNE_STEPS = 10
TUNE_MESH = (1, 4, 1)        # (pod, data, model): DP 4 on the logical mesh
EF_CONVERGE = 0.5            # the compressed run's loss falls at least
                             # this share of the uncompressed run's fall
                             # (0.96 at smoke size on the CPU, 0.81 at
                             # full width on an H100)
TRAIN4K_BATCH = 2            # train_4k cut to a global batch of 2
DECODE_PROMPT = 4096         # prompt prefilled into the decode_32k cache
DECODE_STEPS = 4
WHISPER_PROMPT, WHISPER_NEW = 8, 8


def _dispatch_us(fn, n):
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t0) / n


def _hold_acc(torch, kmm, ops, plan, dt, g, device):
    """Kernel #2 on the winner's tile against its plain version: a clean
    two-call chain (phase 6's checks: c within RTOL, int8 bit-exact, the
    state within the terms' RTOL, the chain re-verified with residual 0).
    Returns max |c - plain|."""
    m, k, n = plan.m, plan.k, plan.n
    if device == "cuda":
        a0, b0, out = _acc_inputs(torch, g, m, k, n, dt)
        a, b, _ = _acc_inputs(torch, g, m, k, n, dt)
    else:
        a0, b0, a, b = (torch.randn((m, k) if i % 2 == 0 else (k, n),
                                    generator=g) for i in range(4))
        out = torch.float32
    wm = ops.kernel_weights(m, device=device)
    wn = ops.kernel_weights(n, device=device).T.contiguous()
    st0 = ops.acc_state_zeros(plan, device=device)
    kw = dict(bm=plan.bm, bn=plan.bn, verify=True,
              eps_c=ops.detection_eps(out))
    c0 = torch.zeros((m, n), dtype=out, device=device)
    c1, ccol1, crow1, _ = kmm.abft_matmul_acc_cuda(a0, b0, c0, *st0, wm, wn,
                                                   **kw)
    got = kmm.abft_matmul_acc_cuda(a, b, c1, ccol1, crow1, wm, wn, **kw)
    want = kmm.abft_matmul_acc_plain(a, b, c1, ccol1, crow1, wm, wn, **kw)
    if float(got[3][..., 4:6].abs().max()) != 0.0:
        raise AssertionError("autotuned kernel #2: the clean chain "
                             "re-verified with a residual")
    cg, cp = got[0].double(), want[0].double()
    if out == torch.int32 and not torch.equal(got[0], want[0]):
        raise AssertionError("autotuned kernel #2: int8 c not bit-exact")
    if not within(cg, cp, float(cp.abs().max())):
        raise AssertionError("autotuned kernel #2: c differs from plain")
    terms = float((wm.abs().double() @ cp.abs()).max())
    for x, y in zip(got[1:3], want[1:3]):
        if not within(x.double(), y.double(), terms):
            raise AssertionError("autotuned kernel #2: state differs")
    return float((cg - cp).abs().max())


def _tune_autotune(torch, row, device, smoke, tmp):
    """(a) The autotuner over kernels #1 and #2: the CLI's bench set and
    Qwen2-0.5B's served projection shapes (family one, every operand
    type), then the SUMMA's accumulate shape; each winner held against its
    plain version; a warm re-run; dispatch from the warmed cache."""
    import repro_torch.core as core
    from repro_torch.core import abft_gemm as ag
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import ops
    from repro_torch.launch import autotune as cli
    from repro_torch.launch import stress

    cfg_shapes = [(1024, k, n) for k, n, _ in SERVE_SHAPES] + \
        [(4, k, n) for k, n, _ in SERVE_SHAPES]
    acc_shape = (SUMMA_NB,) * 3
    if smoke:
        cfg_shapes = [(64, 96, 130), (4, 96, 34)]
        acc_shape = (128, 128, 128)
    args = sum((["--shape", "x".join(map(str, s))] for s in cfg_shapes), [])
    if not smoke:
        args += ["--shapes", "bench"]
    args += ["--dtypes", "float32,bfloat16,int8", "--top-k", "4", "--reps",
             "3", "--device", device]
    cuda = device == "cuda"
    runs = []
    kmm.reset_counts()                       # the tuning's launches
    for tag in ("cold", "warm"):
        out = tmp / f"autotune-{tag}.json"
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            cli.main(args + ["--json", str(out)])
        summary = json.loads(out.read_text())
        at.reset_stats()
        acc_plan, acc_info = at.autotune(*acc_shape, carry=True,
                                         require_exact=True, top_k=4, reps=3,
                                         device=device)
        summary["acc"] = dict(acc_info, measurements=at.stats()[
            "measurements"], blocks=[acc_plan.bm, acc_plan.bn, acc_plan.bk],
            route=acc_plan.route)
        runs.append(summary)
        if tag == "cold":
            launches = (kmm.launches, kmm.acc_launches) if cuda \
                else (kmm.plain_calls, kmm.acc_plain_calls)
    cold, warm = runs
    if cuda and (launches[0] == 0 or launches[1] == 0):
        raise AssertionError(f"autotune launched kernel #1 {launches[0]} "
                             f"and kernel #2 {launches[1]} times")
    if warm["measurements"] != 0 or warm["acc"]["measurements"] != 0 \
            or warm["cache_hits"] != len(warm["plans"]) \
            or warm["acc"]["source"] != "cache":
        raise AssertionError(f"the warm re-run measured: {warm}")
    if cold["acc"]["source"] != "measured" or cold["measurements"] == 0:
        raise AssertionError("the cold run measured nothing")
    for r in cold["plans"]:
        log("tuning", f"(a) {r['key']}: model {r['model_us']:.1f} us, "
                      f"winner {r['blocks']} ({r['route']}) "
                      f"{r['best_us']:.1f} us")
    acc = cold["acc"]
    mb = "x".join(map(str, acc["model_blocks"]))
    log("tuning", f"(a) {acc['key']}: model {acc['measured_us'][mb]:.1f} "
                  f"us, winner {acc['blocks']} ({acc['route']}) "
                  f"{acc['best_us']:.1f} us")
    # every winner against its plain version (phases 3 and 6 tolerances)
    g = torch.Generator(device=device).manual_seed(18)
    errs = []
    for r in cold["plans"]:
        dims, dt_name = r["key"].split("/")[-1], r["key"].split("/")[3]
        m, k, n = map(int, dims.split("x"))
        dt = getattr(torch, dt_name.split("->")[0])
        out = torch.int32 if dt == torch.int8 else torch.float32
        plan = at.best_plan(m, k, n, in_dtype=dt, out_dtype=out,
                            device=device)
        if f"{plan.bm}x{plan.bn}x{plan.bk}" != r["blocks"]:
            raise AssertionError(f"{r['key']}: dispatch plans {plan}")
        if dt == torch.int8:
            a = torch.randint(-127, 128, (m, k), generator=g, device=device,
                              dtype=torch.int8)
            b = torch.randint(-127, 128, (k, n), generator=g, device=device,
                              dtype=torch.int8)
        else:
            a = torch.randn((m, k), generator=g, device=device).to(dt)
            b = (torch.randn((k, n), generator=g, device=device)
                 * k ** -0.5).to(dt)
        wm = ops.kernel_weights(m, device=device)
        wn = ops.kernel_weights(n, device=device).T.contiguous()
        kw = dict(bm=plan.bm, bn=plan.bn, bk=plan.bk, out_dtype=out)
        got = kmm.abft_matmul_cuda(a, b, wm, wn, splits=plan.splits, **kw)
        if cuda and (kmm.last_route["route"] != plan.route
                     or kmm.last_route["splits"] != plan.splits):
            raise AssertionError(f"{r['key']} ran {kmm.last_route}")
        errs.append(hold_oneshot(torch, kmm, (a, b, wm, wn), kw, got)[0])
    acc_plan = at.best_plan(*acc_shape, carry=True, require_exact=True,
                            device=device)
    errs.append(_hold_acc(torch, kmm, ops, acc_plan, torch.float32, g,
                          device))
    # dispatch from the warmed cache: a protected projection and a SUMMA
    m, k, n = cfg_shapes[0]
    at.reset_stats()
    x = torch.randn((m, k), generator=g, device=device)
    w = torch.randn((k, n - 2), generator=g, device=device) * k ** -0.5
    acfg = ag.ABFTConfig(mode="verify", backend="auto" if cuda else "cuda")
    y, ok = ag.abft_matmul(x, ag.encode_weight(w, acfg), acfg)
    want_plan = at.best_plan(m, k, n, out_dtype=torch.float32,
                             device=device)
    proj_hits = at.stats()["cache_hits"]
    if cuda and (kmm.last_route["route"] != want_plan.route
                 or kmm.last_route["splits"] != want_plan.splits):
        raise AssertionError(f"the projection ran {kmm.last_route}, cached "
                             f"{want_plan}")
    if not bool(ok):
        raise AssertionError("the protected projection flagged a clean "
                             "product")
    nb = acc_shape[0]
    spec = core.make_spec(1, 1, 1, device=device)
    sa = torch.randn((nb, 2 * nb), generator=g, device=device)
    sb = torch.randn((2 * nb, nb), generator=g, device=device)
    sx = torch.randn((nb,), generator=g, device=device)
    a_enc, b_enc = core.encode_operands(sa, sb, spec)
    c_enc = core.abft_summa(a_enc, b_enc, 2, spec=spec,
                            local_update="auto" if cuda else "cuda")
    resid = stress.residual_check(core.strip(c_enc, nb, nb), sa, sb, sx)
    st = at.stats()
    if proj_hits < 1 or st["cache_hits"] < proj_hits + 1 \
            or not resid < stress.THRESHOLD:
        raise AssertionError(f"dispatch from the cache: stats {st}, "
                             f"projection hits {proj_hits}, SUMMA residual "
                             f"{resid}")
    if cuda and tuple(kmm.last_acc_route["tile"]) != (acc_plan.bm,
                                                      acc_plan.bn):
        raise AssertionError(f"the SUMMA ran {kmm.last_acc_route}, cached "
                             f"{acc_plan}")
    # the host time of one dispatch
    kwp = dict(in_dtype=torch.float32, out_dtype=torch.float32,
               device=torch.device(device))
    warm_us = _dispatch_us(lambda: at.best_plan(m, k, n, **kwp), 20000)

    def cold_once():
        at.refresh()
        at.best_plan(m, k, n, **kwp)
    cold_us = _dispatch_us(cold_once, 200)
    pick_us = _dispatch_us(lambda: ops.pick_blocks(
        m, k, n, in_dtype=torch.float32, out_bytes=4, f=2), 20000)

    def pick_cold():
        ops.pick_blocks.cache_clear()
        ops.pick_blocks(m, k, n, in_dtype=torch.float32, out_bytes=4, f=2)
    pick_cold_us = _dispatch_us(pick_cold, 200)
    row.update(
        keys=len(cold["plans"]) + 1, measurements=cold["measurements"]
        + cold["acc"]["measurements"], warm_measurements=0,
        kernel1_launches=launches[0], kernel2_launches=launches[1],
        max_abs_err=max(errs), projection_cache_hits=proj_hits,
        summa_cache_hits=st["cache_hits"] - proj_hits, summa_residual=resid,
        plans=cold["plans"], acc=acc, dispatch_us=dict(
            best_plan_warm=warm_us, best_plan_cold=cold_us,
            pick_blocks_warm=pick_us, pick_blocks_cold=pick_cold_us))
    log("tuning", f"(a) {row['keys']} keys, {row['measurements']} "
                  f"measurements (kernel #1 {launches[0]}, kernel #2 "
                  f"{launches[1]} launches), warm re-run 0; every winner "
                  f"held to its plain version, max |c - plain| "
                  f"{max(errs):.4g}; the projection and the SUMMA step "
                  f"from the cache ({st['cache_hits']} hits, SUMMA residual "
                  f"{resid:.4g}); one dispatch: best_plan {warm_us:.2f} us "
                  f"warm, {cold_us:.2f} us cold; pick_blocks {pick_us:.2f} "
                  f"us memoized, {pick_cold_us:.2f} us cold")
    return launches


def _checked_ef(torch, real, seen):
    """``ef_psum_tree`` that also holds each reduction to int8 error
    feedback's own bounds, per leaf: every new residual within half a
    quantization level of its shard (|r'_j| <= scale_j / 2), and the mean
    within the mean of those half levels of the exact mean of gradients
    plus carried residuals.  Records the worst ratios in ``seen``."""
    from repro_torch.tree import tree_leaves

    def fn(grads, residual, axes, ndp, **kw):
        mean, new_res = real(grads, residual, axes, ndp, **kw)
        for g, r, mu, nr in zip(tree_leaves(grads), tree_leaves(residual),
                                tree_leaves(mean), tree_leaves(new_res)):
            x = (g.float() + r).reshape(ndp, -1)
            amax = x.abs().amax(dim=1)
            # half a level, plus the fp32 rounding of x - q * scale
            half = torch.clamp(amax, min=1e-30) / 254.0 + 2.0 ** -22 * amax
            r_ratio = (nr.reshape(ndp, -1).abs()
                       / half[:, None]).amax()
            m_ratio = ((mu.reshape(-1) - x.mean(dim=0)).abs().amax()
                       / (half.sum() / ndp))
            seen["residual"] = max(seen.get("residual", 0.0), float(r_ratio))
            seen["mean"] = max(seen.get("mean", 0.0), float(m_ratio))
            del x
        seen["reductions"] = seen.get("reductions", 0) + 1
        return mean, new_res
    return fn


def _tune_compressed(torch, row, device, smoke):
    """(b) Qwen2-0.5B at full width in fp32 on the logical (1, 4, 1) mesh
    through ElasticRuntime, 10 steps each from the same seeded state:
    int8-EF with zero2, the uncompressed deferred step, zero2, fsdp."""
    from repro_torch.configs.base import ShapeConfig, get_config, \
        smoke_config
    from repro_torch.ft.runtime import ElasticRuntime, FTPolicy
    from repro_torch.kernels import checksum_encode as kenc
    from repro_torch.train import step as tstep
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import StepOptions
    from repro_torch.tree import tree_leaves

    name = "qwen2-0.5b"
    cfg = dataclasses.replace(
        smoke_config(name) if smoke else get_config(name), dtype="float32")
    shape = ShapeConfig("tune", 16 if smoke else 128, 16, "train")
    cuda = device == "cuda"
    variants = [
        ("int8_ef+zero2", dict(defer_grad_reduce=True, zero2=True,
                               grad_compression="int8_ef")),
        ("deferred", dict(defer_grad_reduce=True)),
        ("zero2", dict(defer_grad_reduce=True, zero2=True)),
        ("fsdp", dict(defer_grad_reduce=True, fsdp=True)),
    ]
    runs = {}
    for key, kw in variants:
        _free(torch, device)
        rt = ElasticRuntime(cfg, shape, TUNE_MESH,
                            opts=StepOptions(**kw),
                            adamw=AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=TUNE_STEPS),
                            policy=FTPolicy(diskless_every=5),
                            device=device)
        real_ef = tstep.ef_psum_tree
        bounds = {}
        try:
            state = rt.init_state(0)
            compressed = "grad_compression" in kw
            if compressed:
                tstep.ef_psum_tree = _checked_ef(torch, real_ef, bounds)
            kenc.reset_counts()
            losses = []
            for i in range(TUNE_STEPS):
                state, m = rt.train_step(i, state)
                losses.append(float(m["loss"]))
                if compressed:
                    rt.checkpoint(i, state)
            if cuda:
                torch.cuda.synchronize()
            enc = (kenc.launches, kenc.plain_calls) if cuda \
                else (kenc.plain_calls, 0)
            out = dict(losses=losses, step_walls=list(rt.step_times),
                       peak_gb=_gb(torch, device), split=rt.gen.split,
                       params=[x.clone() for x in tree_leaves(
                           state["params"])] if key != "int8_ef+zero2"
                       else None)
            if compressed:
                res = tree_leaves(state["ef_residual"])
                out.update(
                    residual_norm=float(torch.sqrt(sum(
                        (x.double() ** 2).sum() for x in res))),
                    residual_bytes=sum(x.numel() * 4 for x in res),
                    encode_launches=enc[0], encode_plain=enc[1],
                    encodes=len(rt.timings["encode"]), ef_bounds=bounds)
                if enc[0] == 0 or enc[1] != 0:
                    raise AssertionError(f"the compressed run's encodes: "
                                         f"kernel #3 {enc[0]} launches, "
                                         f"{enc[1]} plain calls")
            runs[key] = out
        finally:
            tstep.ef_psum_tree = real_ef
            rt.close()
            del rt
            state = None
    base = runs["deferred"]["losses"]
    ef = runs["int8_ef+zero2"]
    dl = [a - b for a, b in zip(ef["losses"], base)]
    worst = max(abs(d) / abs(b) for d, b in zip(dl, base))
    b = ef["ef_bounds"]
    if b.get("reductions") != TUNE_STEPS or b["residual"] > 1.0 \
            or b["mean"] > 1.0:
        raise AssertionError(f"int8-EF reductions leave their bounds: {b}")
    fall, base_fall = ef["losses"][0] - ef["losses"][-1], base[0] - base[-1]
    if not all(math.isfinite(x) for x in ef["losses"]) \
            or not 0 < EF_CONVERGE * base_fall <= fall:
        raise AssertionError(f"int8-EF run does not converge: "
                             f"{ef['losses']} against {base}")
    for key in ("zero2", "fsdp"):
        r = runs[key]
        same = r["losses"] == base and all(torch.equal(a, b) for a, b in zip(
            r["params"], runs["deferred"]["params"]))
        if not same:
            raise AssertionError(f"{key} is not the deferred step bit for "
                                 f"bit: losses {r['losses']} against {base}")
    for r in runs.values():
        r.pop("params", None)
    row.update(runs=runs, loss_diff=dl, worst_rel_loss_diff=worst,
               fall=fall, base_fall=base_fall, converge=EF_CONVERGE)
    med = {k: _median(r["step_walls"][1:]) for k, r in runs.items()}
    log("tuning", f"(b) {cfg.name} fp32 on {TUNE_MESH}, {TUNE_STEPS} steps "
                  f"each: int8-EF + zero2 loss - uncompressed "
                  f"{[round(d, 6) for d in dl]} (worst {worst:.3g} of the "
                  f"loss; it falls {fall:.4g}, {fall / base_fall:.3f} of "
                  f"the uncompressed fall >= {EF_CONVERGE}); every "
                  f"reduction within int8 "
                  f"error feedback's bounds (worst residual {b['residual']:.3f}"
                  f" and mean {b['mean']:.3f} of their bounds); residual norm "
                  f"{ef['residual_norm']:.4g} ({ef['residual_bytes'] / 1e9:.2f}"
                  f" GB); zero2 and fsdp bit for bit the deferred step; "
                  f"median step walls (s) {json.dumps(med)}; peak GB "
                  f"{json.dumps({k: r['peak_gb'] for k, r in runs.items()})}"
                  f"; kernel #3 {ef['encode_launches']} launches over "
                  f"{ef['encodes']} encodes")
    return ef["encode_launches"]


def _start_dryrun(tmp, smoke):
    """(c)'s dry run of every valid Qwen2-0.5B cell on pod1 and pod2, in a
    process of its own (meta tensors only: host work beside the card's)."""
    out = tmp / "dryrun"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "qwen2-0.5b", "--all", "--meshes", "pod1,pod2", "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if smoke:
        cmd = [sys.executable, "-c", "print('skipped at smoke size')"]
    log_f = open(tmp / "dryrun.log", "w")
    proc = subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT,
                            env=env, cwd=str(ROOT))
    return proc, out, log_f


def _tune_dryrun(torch, row, device, smoke, dry):
    """(c) The dry run's cells, then two of them cut to one card and run
    for real through the builders: train_4k (global batch 2, mesh (1, 1),
    remat, so seq 4096 takes the FA-2 backward) and decode_32k (batch 1:
    a prefill of 4096 tokens into the 32k cache, then decode steps); the
    dry run's memory and FLOPs beside the measured ones, and the
    attention backward's peak memory, FA-2 against autograd through the
    chunk loop."""
    from repro_torch.configs.base import ShapeConfig, get_config, \
        smoke_config
    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention as tattn
    from repro_torch.models import transformer as tf
    from repro_torch.train.step import (StepOptions, build_prefill_step,
                                        build_serve_step, build_train_step,
                                        init_state, make_inputs)

    proc, out_dir, log_f = dry
    rc = proc.wait(timeout=600)
    log_f.close()
    if rc != 0:
        raise AssertionError(f"the dry run failed ({rc}): "
                             + (out_dir.parent / "dryrun.log").read_text()
                             [-2000:])
    cells = [json.loads(p.read_text())
             for p in sorted(out_dir.glob("*.json"))] if not smoke else []
    if not smoke and len(cells) != 6:
        raise AssertionError(f"dry run wrote {len(cells)} cells, not 6")
    for c in cells:
        mem = c["memory"]
        log("tuning", f"(c) dry run {c['shape']} on {c['tag']} "
                      f"{tuple(c['mesh'].values())}: flops/device "
                      f"{c['flops_per_device']:.4g}, argument "
                      f"{mem['argument_bytes'] / 1e9:.3f} GB + temp "
                      f"{mem['temp_bytes'] / 1e9:.3f} GB a device, "
                      f"collectives {c['collective_bytes_per_device']}, "
                      f"planned in {c['account_s']} s")
    name = "qwen2-0.5b"
    cfg = smoke_config(name) if smoke else get_config(name)
    cuda = device == "cuda"
    seq = 1040 if smoke else 4096
    mesh = make_mesh((1, 1), ("data", "model"), device=device)
    meta = make_mesh((1, 1), ("data", "model"), device="meta")
    g = torch.Generator(device=device).manual_seed(4)
    real = {}

    # train_4k cut to a global batch of 2, two microbatches of 1
    shape = ShapeConfig("train_4k", seq, TRAIN4K_BATCH, "train")
    opts = StepOptions(microbatches=TRAIN4K_BATCH, remat=True)
    dry_t = dryrun_cell(name, shape, meta, opts=opts, verbose=False,
                        cfg_overrides=None if not smoke else
                        {f.name: getattr(cfg, f.name) for f in
                         dataclasses.fields(cfg) if f.name != "name"})
    _free(torch, device)
    fn = build_train_step(cfg, shape, opts=opts, mesh=mesh)
    state = init_state(g, cfg, opts, mesh)
    batch = make_inputs(cfg, shape, structs=False, device=device)
    for k in ("tokens", "labels"):
        batch[k] = torch.randint(0, cfg.vocab_size, batch[k].shape,
                                 generator=g, device=device,
                                 dtype=batch[k].dtype)
    base = _gb(torch, device, peak=False)
    walls = []
    for _ in range(2):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        if cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not math.isfinite(float(m["loss"])):
        raise AssertionError("train_4k loss is not finite")
    real["train_4k"] = dict(wall_s=walls[-1], peak_gb=_gb(torch, device),
                            state_gb=base, loss=float(m["loss"]),
                            tflops=dry_t["step_flops"] / walls[-1] / 1e12)
    del state, batch, fn, m
    # decode_32k cut to batch 1: one prefill, then decode steps
    _free(torch, device)
    cache_len = 2 * seq if smoke else 32768
    prompt = seq
    dshape = ShapeConfig("decode_32k", cache_len, 1, "decode")
    pshape = ShapeConfig("prefill", cache_len, 1, "prefill")
    dry_d = dryrun_cell(name, dshape, meta, verbose=False,
                        cfg_overrides=None if not smoke else
                        {f.name: getattr(cfg, f.name) for f in
                         dataclasses.fields(cfg) if f.name != "name"})
    params = tf.init_params(g, cfg)
    pf, _, _ = build_prefill_step(cfg, mesh, pshape)
    sf, _, _ = build_serve_step(cfg, mesh, dshape)
    cache = tf.init_cache(cfg, 1, cache_len, device=device)
    tok = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                        device=device, dtype=torch.int32)
    with torch.no_grad():
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = pf(params, {"tokens": tok}, cache)
        if cuda:
            torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        dwalls = []
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        for i in range(DECODE_STEPS):
            t0 = time.perf_counter()
            logits, cache = sf(params, {"tokens": nxt, "pos": torch.tensor(
                prompt + i, dtype=torch.int32, device=device)}, cache)
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            if cuda:
                torch.cuda.synchronize()
            dwalls.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode_32k logits are not finite")
    real["decode_32k"] = dict(prefill_s=t_prefill,
                              decode_step_s=_median(dwalls[1:]),
                              peak_gb=_gb(torch, device),
                              tflops=dry_d["step_flops"]
                              / _median(dwalls[1:]) / 1e12)
    del params, cache, logits
    # the attention layer's backward at seq 4096: FA-2 against autograd
    # through the chunk loop (the path it replaces)
    _free(torch, device)
    hd = cfg.resolved_head_dim
    g_kv, grp = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q = torch.randn((1, seq, g_kv, grp, hd), generator=g, device=device)
    kk = torch.randn((1, seq, g_kv, hd), generator=g, device=device)
    vv = torch.randn((1, seq, g_kv, hd), generator=g, device=device)
    pos = torch.arange(seq, device=device)
    kw = dict(scale=hd ** -0.5, softcap=None, causal=True, window=None,
              kc=512)
    attn_peak = {}
    grads = {}
    for key in ("fa2", "autograd"):
        _free(torch, device)
        x = [t.clone().requires_grad_(True) for t in (q, kk, vv)]
        base = _gb(torch, device, peak=False)
        if key == "fa2":
            o = tattn._sdpa_flash(*x, q_pos=pos, k_pos=pos, **kw)
        else:
            o = tattn._flash_fwd_impl(*x, pos, pos, **kw)[0]
        o.sum().backward()
        attn_peak[key] = _gb(torch, device) - base
        grads[key] = [t.grad for t in x]
    gerr = max(float((a - b).abs().max()) for a, b in zip(*grads.values()))
    if gerr > 1e-3 * max(float(b.abs().max()) for b in grads["autograd"]):
        raise AssertionError(f"FA-2 gradients leave autograd's: {gerr}")
    row.update(dry_cells=[{k: c[k] for k in ("shape", "tag",
                                              "flops_per_device", "memory",
                                              "collective_bytes_per_device",
                                              "account_s")} for c in cells],
               train_4k=dict(dry=dict(flops=dry_t["step_flops"],
                                      memory=dry_t["memory"]),
                             real=real["train_4k"]),
               decode_32k=dict(dry=dict(flops=dry_d["step_flops"],
                                        memory=dry_d["memory"]),
                               real=real["decode_32k"]),
               attention_bwd_peak_gb=attn_peak, fa2_grad_err=gerr)
    for key, dry_r in (("train_4k", dry_t), ("decode_32k", dry_d)):
        mem = dry_r["memory"]
        est = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
        r = real[key]
        log("tuning", f"(c) {key} cut to one card: dry run argument + temp "
                      f"{est:.3f} GB against a measured peak of "
                      f"{r['peak_gb']:.3f} GB ({r['peak_gb'] / est:.2f}x); "
                      f"{dry_r['step_flops']:.4g} FLOPs a step, measured "
                      + (f"{r['wall_s']:.3f} s a step" if key == "train_4k"
                         else f"prefill {r['prefill_s']:.3f} s, "
                              f"{r['decode_step_s'] * 1e3:.2f} ms a decode "
                              f"step") + f" ({r['tflops']:.3g} TFLOP/s)")
    log("tuning", f"(c) attention backward at seq {seq}: FA-2 peak "
                  f"{attn_peak['fa2']:.4f} GB, autograd through the chunk "
                  f"loop {attn_peak['autograd']:.4f} GB; gradients within "
                  f"{gerr:.3g}")


def _tune_whisper(torch, row, device, smoke):
    """(d) Whisper-large-v3 at full width in fp32 through the builders: a
    prefill over the frames, then greedy decode steps, every protected
    projection on kernel #1; the tokens held to greedy decoding by the full
    forward over the same frames (phase 16's rule)."""
    from repro_torch.configs.base import ShapeConfig, get_config, \
        smoke_config
    from repro_torch.core.abft_gemm import ABFTConfig
    from repro_torch.kernels import abft_matmul as kmm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.step import (StepOptions, build_prefill_step,
                                        build_serve_step)

    _free(torch, device)
    name = "whisper-large-v3"
    cfg = dataclasses.replace(
        smoke_config(name) if smoke else get_config(name), dtype="float32")
    cuda = device == "cuda"
    g = torch.Generator(device=device).manual_seed(5)
    params = tf.init_params(g, cfg)
    b, sp, new = 2, WHISPER_PROMPT, WHISPER_NEW
    s = sp + new + 1
    frames = torch.randn((b, cfg.n_frames, cfg.d_model), generator=g,
                         device=device)
    prompt = torch.randint(0, cfg.vocab_size, (b, sp), generator=g,
                           device=device, dtype=torch.int32)
    opts = StepOptions(abft_mode="verify",
                       abft_backend="auto" if cuda else "cuda")
    mesh = make_mesh((1, 1), ("data", "model"), device=device)
    pf, _, _ = build_prefill_step(cfg, mesh, ShapeConfig("p", s, b,
                                                         "prefill"), opts)
    sf, _, _ = build_serve_step(cfg, mesh, ShapeConfig("d", s, b, "decode"),
                                opts)
    kmm.reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        cache = tf.init_cache(cfg, b, s, device=device)
        logits, cache = pf(params, {"tokens": prompt, "frames": frames},
                           cache)
        out = [logits.argmax(-1)]
        for i in range(new):
            logits, cache = sf(params, {
                "tokens": out[-1].to(torch.int32)[:, None],
                "pos": torch.tensor(sp + i, dtype=torch.int32,
                                    device=device)}, cache)
            out.append(logits.argmax(-1))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, other = _counts(kmm, device)
    want = protected_per_pass(cfg, stash=True) + \
        new * protected_per_pass(cfg, decode=True)
    if launches != want or other != 0:
        raise AssertionError(f"whisper through the builders: kernel #1 "
                             f"{launches} launches (want {want}), {other} "
                             "plain calls")
    emitted = torch.stack(out, dim=1)                       # [b, new + 1]
    seq = torch.cat([prompt.long(), emitted[:, :-1]], dim=1)
    plain = ABFTConfig(mode="verify", backend="ref")
    with torch.no_grad():
        lk = tf.forward(params, seq, cfg, frames=frames,
                        abft=opts.abft)[0][:, sp - 1:].float()
        lp = tf.forward(params, seq, cfg, frames=frames,
                        abft=plain)[0][:, sp - 1:].float()
    noise = float((lk - lp).abs().max())
    chosen = lk.gather(2, emitted[..., None])[..., 0]
    short = (lk.max(dim=2).values - chosen)
    exact = int((short == 0).sum())
    if exact < short.numel() and float(short.max()) > 2 * noise:
        raise AssertionError(f"whisper's greedy tokens leave the full "
                             f"forward: short {short.tolist()}, noise "
                             f"{noise}")
    row.update(tokens=emitted.tolist(), exact=exact, of=short.numel(),
               worst_short=float(short.max()), noise=noise,
               launches=launches, wall_s=wall, peak_gb=_gb(torch, device))
    log("tuning", f"(d) {name} fp32 through build_prefill_step and "
                  f"build_serve_step: prefill {b} x {sp} over "
                  f"{cfg.n_frames} frames, {new} greedy decode steps; "
                  f"{exact} of {short.numel()} tokens the full forward's "
                  f"argmax, the rest within 2 x noise {2 * noise:.3g}; "
                  f"kernel #1 {launches} launches, no plain call; "
                  f"{wall:.2f} s, peak {row['peak_gb']:.2f} GB")
    del params, cache
    return launches


def phase_tuning(torch, record, card, device="cuda", smoke=False):
    """Phase 18: tune, then plan, then train compressed, then serve
    through the step builders.  Returns the launches of kernels #1, #2
    and #3 on its path: (autotune #1, autotune #2, the compressed run's
    encodes #3, Whisper's #1)."""
    import tempfile

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    rows = {k: {} for k in "abcd"}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        tmp = pathlib.Path(d)
        # run alone (not from main), the phase tunes into a cache of its own
        os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE",
                              str(tmp / "autotune.json"))
        dry = _start_dryrun(tmp, smoke)
        walls = {}
        try:
            t0 = time.perf_counter()
            launches = _tune_autotune(torch, rows["a"], device, smoke, tmp)
            walls["a"] = time.perf_counter() - t0
            enc = _tune_compressed(torch, rows["b"], device, smoke)
            walls["b"] = time.perf_counter() - t0 - walls["a"]
            _tune_dryrun(torch, rows["c"], device, smoke, dry)
            walls["c"] = time.perf_counter() - t0 - walls["a"] - walls["b"]
            whisper = _tune_whisper(torch, rows["d"], device, smoke)
            walls["d"] = time.perf_counter() - t0 - sum(walls.values())
        finally:
            if dry[0].poll() is None:
                dry[0].kill()
                dry[0].wait()
            dry[2].close()
    _free(torch, device)
    wall = time.perf_counter() - t_phase
    log("tuning", f"phase {wall:.1f} s (parts (s): "
                  f"{json.dumps({k: round(v, 1) for k, v in walls.items()})})"
                  f"; {card}")
    record["tuning"] = dict(rows, phase_s=wall, part_s=walls, card=card)
    return launches[0], launches[1], enc, whisper


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's path runs on the GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE fp32 everywhere
    torch.backends.cudnn.allow_tf32 = False
    # a fresh autotune cache of this run's own: phases 1-17 plan cold (the
    # time model), phase 18 warms it
    (ROOT / "build").mkdir(exist_ok=True)
    at_cache = ROOT / "build" / f"autotune-{os.getpid()}.json"
    at_cache.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(at_cache)
    for knob in ("REPRO_TORCH_AUTOTUNE_PLAN", "REPRO_TORCH_AUTOTUNE_DISABLE"):
        os.environ.pop(knob, None)
    from repro_torch.kernels import build

    record = {}
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}, {torch.cuda.device_count()} visible, torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    record["nvidia_smi"] = smi

    phase_build(torch, record)
    rows = phase_kernel(torch, record)
    phase_drill(torch, record)
    launches = phase_serve(torch, record, f"{name} ({smi})")
    acc_rows = phase_acc(torch, record)
    acc_launches = phase_summa(torch, record, f"{name} ({smi})")
    enc_rows = phase_encode(torch, record)
    enc_launches, enc_tot = phase_train(torch, record, f"{name} ({smi})")
    flash_rows = phase_flash(torch, record)
    chaos_counts = phase_chaos(torch, record)
    phase_serve_ft(torch, record, f"{name} ({smi})")
    ft_launches = phase_train_ft(torch, record, f"{name} ({smi})")
    traffic_launches, traffic_err = phase_traffic(torch, record,
                                                  f"{name} ({smi})")
    phase_solver(torch, record, f"{name} ({smi})")
    families_launches, families_err = phase_families(torch, record,
                                                     f"{name} ({smi})")
    elastic_launches = phase_elastic(torch, record, f"{name} ({smi})")
    tune1, tune2, tune_enc, tune_whisper = phase_tuning(
        torch, record, f"{name} ({smi})")
    at_cache.unlink(missing_ok=True)

    # one record per kernel: one prefill layer (m = 1024) plus one decode
    # layer (m = 4) of fp32 operands, as served: 7 projections each
    served = [r for r in rows
              if r["dtype"] == "float32" and r["set"] == "serve"]
    tot = {key: sum(r[key] * r["per_layer"] for r in served)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    by_ops = sum(r["bound_ms"] * r["per_layer"] for r in served
                 if r["bound_by"] == "operations")
    # the accumulate kernel at the SUMMA step shape, fp32 as the SUMMA runs
    step = acc_rows[0]
    # kernel #4's Qwen2-0.5B row in bf16, unchecked
    bf16_row = next(r for r in flash_rows if r["what"] == "qwen2-0.5b"
                    and r["dtype"] == "bfloat16" and not r["checksum"])
    kernels = {"kernels": [{
        "name": "abft_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/abft_matmul.cu",
        "replaces": "src/repro/kernels/abft_matmul.py:285",
        "launches": launches,
        # phase 3's cases and the operands phase 14's and phase 16's
        # engines gave it
        "max_abs_err": max([r["max_abs_err"] for r in rows]
                           + [traffic_err, families_err]),
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if by_ops >= tot["bound_ms"] / 2
                    else "bytes",
        "library_ms": tot["library_ms"],
        # phase 14: the paged engine's clean replay of the traffic trace
        "traffic_launches": traffic_launches,
        # phase 16: the MoE, hybrid, recurrent, Whisper and vision configs
        "families_launches": families_launches,
        # phase 18: the autotuner's measurements and winner holds, and
        # Whisper served through the step builders
        "autotune_launches": tune1,
        "builders_launches": tune_whisper,
    }, {
        "name": "abft_matmul_acc",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/abft_matmul_acc.cu",
        "replaces": "src/repro/kernels/abft_matmul.py:350",
        "launches": acc_launches,
        "max_abs_err": max(r["max_abs_err"] for r in acc_rows),
        "ms": step["ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"],
        "library_ms": step["library_ms"],
        # phase 18: the autotuner's accumulate-family measurements
        "autotune_launches": tune2,
    }, {
        # one diskless encode of the full-width train state: 42 launches,
        # one per floating leaf, their times summed
        "name": "checksum_encode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/checksum_encode.cu",
        "replaces": "src/repro/kernels/checksum_encode.py:32",
        "launches": enc_launches,
        "max_abs_err": max(r["max_abs_err"] for r in enc_rows),
        "ms": enc_tot["ms"],
        "plain_ms": enc_tot["plain_ms"],
        "bound_ms": enc_tot["bound_ms"],
        "bound_by": enc_tot["bound_by"],
        "library_ms": enc_tot["library_ms"],
        # the protected training phase: an encode and a scrub verify per
        # step, one launch per leaf each; and the campaign's encodes and
        # verifies
        "train_ft_launches": ft_launches,
        "chaos_launches": chaos_counts["encode"],
        # phase 17: the pod-loss drills at p = 4 and p = 2, re-keys included
        "elastic_launches": elastic_launches,
        # phase 18: the int8-EF run's encodes, ef_residual included
        "compressed_launches": tune_enc,
    }, {
        # the Qwen2-0.5B attention at full width (4 x 14 heads, S 4096,
        # D 64, causal, fp32), the shape SDPA computes the same function
        # at; the campaign's main path launches it at [2, 512, 64].  The
        # bound is at the 3xTF32 rate; the CUDA-core bound and the bf16
        # row (kernel, bound, SDPA) ride along
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:181",
        "launches": chaos_counts["flash"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows
                           if r["dtype"] == "float32"),
        "ms": flash_rows[0]["ms"],
        "plain_ms": flash_rows[0]["plain_ms"],
        "bound_ms": flash_rows[0]["bound_ms"],
        "bound_by": flash_rows[0]["bound_by"],
        "library_ms": flash_rows[0]["library_ms"],
        "cuda_core_bound_ms": flash_rows[0]["cuda_core_bound_ms"],
        "bf16_ms": bf16_row["ms"],
        "bf16_bound_ms": bf16_row["bound_ms"],
        "bf16_library_ms": bf16_row["library_ms"],
    }]}
    record["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
