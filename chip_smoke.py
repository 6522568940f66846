#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build its CUDA kernels from the
sources in this checkout, hold each kernel against its plain PyTorch version
at the shapes its path gives it, drill ABFT detection and correction on the
card, serve Qwen2-0.5B at its published width through the port's serving
entry point, run the paper's fault-tolerant SUMMA at the paper's size, and
train Qwen2-0.5B at its published width through the port's fault-tolerant
training entry point, with diskless recoveries, hold the checked
flash-attention kernel against its plain version at the Qwen2-0.5B and
Gemma2-2B attention shapes, run the chaos campaign over its train and
serve workloads through its CLI, and drive the protected reductions and the
at-rest scrub at full width: the verified unembed of the serving engine
with an SDC drill and KV and params flips, and the protected train step
under ElasticRuntime with an SDC and DRAM flips.

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
                repro_torch.launch.chaos over the default space's train and
                serve workloads, counts zeroed just before it: its 67 rows
                with the outcome, rung and end state of the reference's
                one-device campaign (CAMPAIGN_ROWS: 50 corrected, 3
                detected, 7 clean sweeps, 7 skipped naming port slice 13;
                episodes 9 corrected, 2 skipped), kernel #4 launched 4 and
                kernel #2 21 times, kernel #3 once per encoded leaf of
                every diskless encode and scrub verify, no plain call,
                nothing missed, no false alarm (the artifact and matrix in
                chiprun_out/chaos.*);
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
                and verify walls.
The line before the last is the per-kernel JSON record, the last line the
device record.  Details go to chiprun_out/chip_smoke.json.
"""
import contextlib
import dataclasses
import io
import json
import math
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
        cp, ccolp, crowp = kmm.abft_matmul_plain(a, b, wm, wn, **kw)
        torch.cuda.synchronize()
        if route["route"] != plan.route or route["splits"] != plan.splits:
            raise AssertionError(f"{(m, k, n, dt)} ran {route}, planned "
                                 f"{plan.route} with {plan.splits} splits")
        if not all(torch.equal(x, y) for x, y in zip((c, ccol, crow), again)):
            raise AssertionError(f"two calls differ at {(m, k, n, dt)}")
        c32, cp32 = c.double(), cp.double()
        err_c = float((c32 - cp32).abs().max())
        if dt == torch.int8:
            if not torch.equal(c, cp):
                raise AssertionError(f"int8 c not bit-exact at {(m, k, n)}")
        elif not within(c32, cp32, float(cp32.abs().max())):
            raise AssertionError(f"c differs at {(m, k, n, dt)}: {err_c}")
        # the checksums are sums of terms |c| |w|; the residual direction
        # ([w_r; -I]) cancels them, so its tolerance scales with the terms
        cs_col, cs_colp = ccol.sum(0).double(), ccolp.sum(0).double()
        cs_row, cs_rowp = crow.sum(0).double(), crowp.sum(0).double()
        terms_col = float((wm.abs().double() @ cp32.abs()).max())
        terms_row = float((cp32.abs() @ wn.abs().double()).max())
        err_col = float((cs_col - cs_colp).abs().max())
        err_row = float((cs_row - cs_rowp).abs().max())
        if not (within(cs_col, cs_colp, terms_col)
                and within(cs_row, cs_rowp, terms_row)):
            raise AssertionError(f"checksums differ at {(m, k, n, dt)}: "
                                 f"{err_col} / {err_row}")
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
        del a, b, c, ccol, crow, again, cp, ccolp, crowp
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


# every row of the reference's one-device campaign over the default space's
# train and serve workloads (PYTHONPATH=src JAX_PLATFORMS=cpu python -m
# repro.launch.chaos --space default --workload both), in its order: name,
# outcome, rung, end state (None = within the promise, for the kernel drills
# whose float repair may land bit-identical on the card)
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
    ('train:shard_loss:s3', 'corrected', 'diskless', 'bit_identical'),
    ('serve:sdc_collective:s1', 'corrected', 'abft_inflight', 'bit_identical'),
    ('serve:dram_kv_cache:s2',
     'corrected', 'scrub:kv_repair', 'bit_identical'),
    ('train:sdc_collective:s4:d-30000:seed1',
     'corrected', 'abft_inflight', 'within_tol'),
    ('serve:sdc_collective:s3:sh1:d-30000:seed1',
     'skipped', None, 'not_compared'),
    ('serve:dram_params:s0', 'corrected', 'scrub:restore', 'bit_identical'),
    ('train:flash_state_flip:s2:l:seed1',
     'corrected', 'flash:recompute_tile', None),
    ('train:checksum_state_flip:s2:b29:int8:seed2',
     'detected', None, 'bit_identical'),
    ('train:sdc_collective:s2:bf16:seed2',
     'corrected', 'kernel:masked_recompute', None),
    ('train:sdc_collective:s2:b28:seed3',
     'corrected', 'kernel:masked_recompute', None),
    ('train:shard_loss:s3:sh1:seed1', 'skipped', None, 'not_compared'),
    ('train:pod_loss:s3:diskless', 'skipped', None, 'not_compared'),
    ('train:pod_loss:s3:disk:seed1', 'skipped', None, 'not_compared'),
    ('train:slow_pod:s1', 'skipped', None, 'not_compared'),
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
    ('train:poisson250::e0:shard_loss',
     'corrected', 'diskless', 'not_compared'),
    ('episode:train:poisson250', 'corrected', 'diskless', 'bit_identical'),
    ('serve:poisson250::e0:dram_kv_cache',
     'corrected', 'scrub:kv_repair', 'not_compared'),
    ('serve:poisson250::e1:sdc_collective',
     'corrected', 'abft_inflight', 'not_compared'),
    ('episode:serve:poisson250',
     'corrected', 'abft_inflight+scrub:kv_repair', 'bit_identical'),
    ('episode:train:dram+podloss', 'skipped', None, 'not_compared'),
    ('episode:train:pod_repeat', 'skipped', None, 'not_compared'),
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
    ('train:clean_sweep:1x1:plain', 'clean', None, 'bit_identical'),
    ('train:clean_sweep:1x1:plain:7st', 'clean', None, 'bit_identical'),
    ('train:clean_sweep:1x1:protected', 'clean', None, 'bit_identical'),
    ('train:clean_sweep:1x1:protected:9st', 'clean', None, 'bit_identical'),
    ('train:clean_sweep:1x1:scrub', 'clean', None, 'bit_identical'),
    ('serve:clean_sweep:1x1', 'clean', None, 'bit_identical'),
    ('serve:clean_sweep:1x1xscrub', 'clean', None, 'bit_identical'),
]
CAMPAIGN_BY_OUTCOME = {"corrected": 50, "absorbed": 0, "detected": 3,
                       "missed": 0, "false_alarm": 0, "clean": 7,
                       "skipped": 7}


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
    """The chaos campaign's CLI over the default space's train and serve
    workloads on the card, counts zeroed just before it: every row the
    reference's one-device campaign runs, with its outcome, rung and end
    state, through ElasticRuntime (kernel #3 for every encode and scrub
    verify), the protected serving engine and the kernel drills."""
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
            rc = chaos.main(["--space", "default", "--workload", "both",
                             "--json", str(out), "--markdown",
                             str(out.with_suffix(".md")), "--quiet"])
        wall = time.perf_counter() - t0
        counts = dict(flash=kfa.launches, flash_plain=kfa.plain_calls,
                      acc=kmm.acc_launches, acc_plain=kmm.acc_plain_calls,
                      encode=kenc.launches, encode_plain=kenc.plain_calls)
    finally:
        undo()
    log("chaos", f"repro_torch.launch.chaos (default space, train + serve) "
                 f"-> {rc} in {wall:.2f} s; launches: kernel #4 "
                 f"{counts['flash']}, kernel #2 {counts['acc']}, kernel #3 "
                 f"{counts['encode']} ({calls['encodes']} encodes + "
                 f"{calls['verifies']} scrub verifies); plain calls "
                 f"{counts['flash_plain']} / {counts['acc_plain']} / "
                 f"{counts['encode_plain']}")
    # the port's uncovered ledger (solver, paged serving, pod topology)
    # fails the gate's ledger clause without --check: rc stays 0
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
        if outcome == "skipped" and "slice 13" not in e["note"]:
            raise AssertionError(f"{name} skipped without naming port slice "
                                 f"13: {e['note']}")
        if name in CHAOS_ROWS or outcome == "skipped":
            log("chaos", f"{name}: {e['outcome']}, rung {e['rung']}, "
                         f"{e['end_state']} (max diff {e['max_abs_diff']})"
                         + (f": {e['note']}" if outcome == "skipped"
                            else ""))
    summ = d["summary"]
    if summ["by_outcome"] != CAMPAIGN_BY_OUTCOME \
            or summ["missed_anywhere"] or summ["false_alarms"]:
        raise AssertionError(f"by outcome {summ['by_outcome']}, missed "
                             f"{summ['missed_anywhere']}, false alarms "
                             f"{summ['false_alarms']}")
    eps = {k: v for k, v in d["episodes"]["by_outcome"].items() if v}
    if eps != {"corrected": 9, "skipped": 2}:
        raise AssertionError(f"episodes {eps}")
    log("chaos", f"{len(events)} rows as the reference's one-device "
                 f"campaign: {summ['by_outcome']}; episodes {eps}; missed "
                 f"[], false alarms []")
    record["chaos"] = dict(rc=rc, wall_s=wall, counts=counts,
                           encode_calls=calls, by_outcome=summ["by_outcome"],
                           episodes=eps)
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's path runs on the GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE fp32 everywhere
    torch.backends.cudnn.allow_tf32 = False
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
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if by_ops >= tot["bound_ms"] / 2
                    else "bytes",
        "library_ms": tot["library_ms"],
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
