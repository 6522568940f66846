"""Protected training as a user runs it: the port's train step
(``train/step.py::build_train_step`` and ``init_state``, the functions that
``launch/train.py`` uses) with ABFT ``correct``: every forward projection
a checked product (kernel #1; a MoE layer's experts on kernel #1g), the
gradients through their VJPs, AdamW, and a dropless MoE's selection bias
moved against its load.

One step is timed on the host's clock with the device synchronized.  Set-up
builds the step and the state from the seed, makes a pool of batches from
the mix on the device, runs two warm steps and copies the state to the
host.  The window runs steps back to back on the pool's batches in turn
and closes after the step that ends past ``--seconds``.  Its first step is
the one compared: its loss, new params, new AdamW moments and the experts
its tokens chose go to the host right after it, with the window's clock
stopped for the copy (``paused``).  Once the window has closed, the plain
float32 reference (``reference/moonlight.py``) routes for itself and takes
the same step from the same params, optimizer state and batch on the
device, in blocks (one layer's activations at a time, then tensor by
tensor).  The loss is compared, and each tensor's update (params after
minus before) and new moments, tensor by tensor: a check reads the worst
tensor's relative error, so that one small tensor left unchanged fails it.
Where the reference cannot separate a token's k-th and (k+1)-th experts (a
near tie, which float32 rounding upstream decides), it takes the choice
the compared step made; the near ties are counted and reported.
``control`` puts the reference with TF32-rounded operands in the program's
place for the compared step.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from portbench.harness.spans import window_spans
from portbench.harness.tokens import token_pool
from portbench.metrics import _moonlight_work as work
from portbench.reference import moonlight as ref

WARM = 2          # steps before the window (the state compared is after)


def _leaves(tree, path=()):
    """[(path, tensor)] of a tree of dicts and lists, keys in sorted order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaves(tree[k],
                                                           path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree) for pl in _leaves(x,
                                                                 path + (i,))]
    return [(path, tree)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return fn(tree)


def _is_bias(path) -> bool:
    return tuple(path[-2:]) == ("moe", "bias")


def _host_copy(tree):
    """A copy of ``tree`` on the host.  Tensors from a card go to
    page-locked memory, into which a card copies several times faster than
    into pageable memory.  PyTorch's pinned allocator rounds each
    allocation up to a power of two (a 738 MB expert stack would take 1 GiB
    alone), so the tensors are packed, largest first, into chunks whose
    sizes are the binary digits of their total, in units of 64 MiB."""
    def pad(n):
        return -(-n // 64) * 64
    leaves = sorted(_leaves(tree), key=lambda pt: -pt[1].numel()
                    * pt[1].element_size())
    dev = [(p, t) for p, t in leaves if t.device.type == "cuda"]
    total = -(-sum(pad(t.numel() * t.element_size()) for _, t in dev)
              // 2 ** 26) * 2 ** 26
    sizes = [1 << k for k in range(total.bit_length(), -1, -1)
             if total >> k & 1]
    chunks = [[torch.empty(n, dtype=torch.uint8, pin_memory=True), 0]
              for n in sizes]
    views = {}
    for path, t in leaves:
        n = t.numel() * t.element_size()
        c = next((c for c in chunks if c[1] + n <= c[0].numel()), None)
        if t.device.type != "cuda" or c is None:
            views[path] = t.detach().to("cpu", copy=True)
            continue
        views[path] = c[0][c[1]:c[1] + n].view(t.dtype).view(t.shape) \
            .copy_(t.detach())
        c[1] += pad(n)
    return _map_path(lambda path, _: views[path], tree)


def _map_path(fn, tree, path=()):
    """``_map`` with each leaf's path: fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, x, path + (i,))
                          for i, x in enumerate(tree))
    return fn(path, tree)


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device: str,
                 log, control: bool = False):
        if mix.get("loop") != "steps":
            raise ValueError("ft_train runs a steps mix")
        self.c, self.mix, self.seed, self.dev, self.log = (config, mix, seed,
                                                           device, log)
        self.control = control
        self.paused = []
        # step WARM's (loss, {path: new param}, {path: new m}, {path: new
        # v}, [each MoE layer's chosen experts]), on the host
        self.after = None

    # -- set-up --
    def _program(self):
        """The port's pieces the cell runs; raises, before anything is
        allocated, where the program lacks the configuration or the
        grouped checked product."""
        from repro_torch.configs import base
        from repro_torch.kernels import ops
        ports = getattr(base, "list_port_configs", lambda: [])()
        if self.c["arch"] not in ports \
                or not hasattr(ops, "abft_matmul_grouped"):
            raise RuntimeError(
                f"the program has no {self.c['arch']!r} configuration or no "
                "grouped checked product (kernels.ops.abft_matmul_grouped): "
                "it cannot run this cell")
        return base

    def _model_config(self, base):
        """The program's configuration at this file's sizes."""
        from repro_torch.launch.serve import cut_layers
        c = self.c
        cfg = base.get_config(c["arch"]).scaled(
            d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
            n_kv_heads=c["num_key_value_heads"],
            d_ff=c["intermediate_size"], moe_dff=c["moe_intermediate_size"],
            n_experts=c["n_routed_experts"], top_k=c["num_experts_per_tok"],
            n_shared_experts=c["n_shared_experts"],
            routed_scale=c["routed_scaling_factor"],
            kv_lora_rank=c["kv_lora_rank"],
            qk_nope_head_dim=c["qk_nope_head_dim"],
            qk_rope_head_dim=c["qk_rope_head_dim"],
            v_head_dim=c["v_head_dim"], rope_theta=float(c["rope_theta"]),
            norm_eps=c["rms_norm_eps"], vocab_size=c["vocab_size"],
            bias_update_rate=c["bias_update_speed"], dtype=c["dtype"])
        return cut_layers(cfg, c["num_hidden_layers"])

    def setup(self):
        t0 = time.perf_counter()
        base = self._program()
        from repro_torch import obs
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.step import (StepOptions, build_train_step,
                                            init_state)
        if self.dev == "cuda":
            from repro_torch.kernels import build
            build.compile_all(("abft_matmul", "abft_matmul_grouped"))
        cfg = self._model_config(base)
        self.cfg = cfg
        self.adamw = AdamWConfig()
        shape = base.ShapeConfig("cell", int(self.mix["seq_len"]),
                                 int(self.mix["sequences"]), "train")
        self.step = build_train_step(
            cfg, shape, self.adamw, StepOptions(
                abft_mode=self.c["abft_mode"], remat=self.c["remat"],
                aux_weight=self.c["aux_loss_alpha"]))
        t1 = time.perf_counter()
        self.pool = torch.from_numpy(
            token_pool(self.mix, cfg.vocab_size, self.seed)).to(self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(
            abs(int(self.seed)) % 2 ** 63)
        self.state = init_state(gen, cfg)
        self._sync()
        t2 = time.perf_counter()
        for i in range(WARM):
            self.state, _ = self.step(self.state, self._batch(i))
        self._sync()
        t3 = time.perf_counter()
        self.before = _host_copy({"params": self.state["params"],
                                  "m": self.state["opt"]["m"],
                                  "v": self.state["opt"]["v"],
                                  "count": self.state["opt"]["count"]})
        t4 = time.perf_counter()
        if self.dev == "cuda":
            from repro_torch.obs import cuda as obs_cuda
            obs_cuda.install()
        obs.reset()
        self.log(f"set-up parts: program, kernels and step {t1 - t0:.3f} s, "
                 f"batches and state {t2 - t1:.3f} s, {WARM} warm steps "
                 f"{t3 - t2:.3f} s, the compared step's state to the host "
                 f"{t4 - t3:.3f} s")

    def _sync(self):
        if self.dev == "cuda":
            torch.cuda.synchronize()

    def _batch(self, i: int) -> dict:
        x = self.pool[i % self.pool.shape[0]]
        return {"tokens": x[:, :-1], "labels": x[:, 1:]}

    # -- the window --
    def window(self, seconds: float, phases) -> dict:
        times, bounds = [], []
        self._sync()
        t_start = time.perf_counter()
        t, paused, i = t_start, 0.0, 0
        while t - t_start - paused < seconds:
            batch = self._batch(WARM + i)
            t0 = time.perf_counter()
            if self.control:
                # the reference, one precision down, in the program's place
                self.after = self._reference_step(batch, tf32=True)
            else:
                self.state, metrics = self.step(self.state, batch)
            with phases("synchronize"):
                self._sync()
            t = time.perf_counter()
            times.append(t - t0)
            bounds.append((t0, t))
            if self.control:
                break
            if i == 0:
                # the compared step's own output, the clock stopped
                with phases("compared step to the host"):
                    self.after = self._program_after(metrics)
                t_back = time.perf_counter()
                self.paused.append((t, t_back))
                paused += t_back - t
                t = t_back
            i += 1
        return dict(kind="products", window_s=t - t_start - paused,
                    t_start=t_start, t_end=t, product_s=times,
                    step_bounds=bounds, paused=self.paused,
                    data_flops=work.checked_fwd_flops(self.c, self.mix),
                    model_flops=work.model_flops(self.c, self.mix),
                    spans=window_spans(t_start, t),
                    attempted=len(times), failed=0)

    def _program_after(self, metrics):
        """The compared step's output on the host."""
        st, chosen = self.state, self.step.moe_chosen
        h = _host_copy({"p": st["params"], "m": st["opt"]["m"],
                        "v": st["opt"]["v"]})
        return (float(metrics["loss"]), dict(_leaves(h["p"])),
                dict(_leaves(h["m"])), dict(_leaves(h["v"])),
                [chosen[li].cpu() for li in sorted(chosen)])

    def release(self):
        """Free the program's state; the host copies stay."""
        self.state = self.step = None
        if self.dev == "cuda":
            torch.cuda.empty_cache()

    # -- the reference --
    def _reference_update(self, params, m, v, count, batch, cfg, visit,
                          chosen=None):
        """The reference's step from ``params`` (a tree on the device) and
        the moments ``m``, ``v`` (trees, on either side), optimizer step
        ``count`` before it: its loss, and ``visit(path, old, new, m', v')``
        for every tensor, one at a time (a selection bias has no moments:
        None).  ``chosen``, a list, gets the experts each MoE layer's tokens
        chose.  Returns (loss, near ties)."""
        blocks = self.dev == "cuda"
        live = _map(lambda t: t.detach().requires_grad_(
            t.is_floating_point()), params)
        loss, loads = ref.loss(live, batch["tokens"], batch["labels"], cfg,
                               blocks=blocks, chosen=chosen)
        train = [(p, x) for p, x in _leaves(live) if not _is_bias(p)]
        grads = torch.autograd.grad(loss, [x for _, x in train])
        gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                              for g in grads))
        hp = dataclasses.asdict(self.adamw)
        mm, vv = dict(_leaves(m)), dict(_leaves(v))
        for (path, p), g in zip(train, grads):
            visit(path, p.detach(), *ref.adamw_step(
                p.detach(), g, mm[path].to(self.dev), vv[path].to(self.dev),
                count + 1, gnorm, hp))
        del grads
        moe = [(path, x) for path, x in _leaves(live) if _is_bias(path)]
        for (path, bias), load in zip(moe, loads):
            visit(path, bias.detach(), ref.bias_step(bias.detach(), load[:-1],
                                                     cfg), None, None)
        return float(loss.detach()), int(sum(int(load[-1]) for load in loads))

    def _reference_step(self, batch, tf32: bool):
        """The control's step, in the form of ``_program_after``'s."""
        new, m, v, chosen = {}, {}, {}, []

        def keep(path, old, p, m_new, v_new):
            new[path] = p.cpu()
            if m_new is not None:
                m[path], v[path] = m_new.cpu(), v_new.cpu()

        loss, _ = self._reference_update(
            self.state["params"], self.state["opt"]["m"],
            self.state["opt"]["v"], int(self.state["opt"]["count"]), batch,
            dict(self.c, tf32=tf32), keep, chosen)
        return loss, new, m, v, [c.cpu() for c in chosen]

    # -- the comparison --
    def check(self) -> list:
        """[(name, value, limit)]: the compared step's loss against the
        reference's; its update of each tensor (params after minus before)
        against the reference's, the worst tensor's relative error; and
        its new AdamW moments m and v likewise, the worst of both."""
        lim = self.c["limits"]
        names = ("loss_rel_err", "update_rel_err", "moments_rel_err")
        if self.after is None:
            return [(n, float("inf"), lim[n]) for n in names]
        got_loss, got, got_m, got_v, choices = self.after
        params = _map(lambda t: t.to(self.dev), self.before["params"])
        batch = self._batch(WARM)
        upd, mom = [], []
        whole = [0.0, 0.0]

        def rel(got_t, want):
            e = float(torch.sum((got_t.double() - want.double()) ** 2))
            r = float(torch.sum(want.double() ** 2))
            return e, r, (math.sqrt(e / r) if r > 0
                          else (0.0 if e == 0 else float("inf")))

        def visit(path, old, new, m_new, v_new):
            e, r, x = rel(got[path].to(self.dev) - old, new - old)
            whole[0], whole[1] = whole[0] + e, whole[1] + r
            upd.append((x, path))
            if m_new is not None:
                mom.append((rel(got_m[path].to(self.dev), m_new)[2],
                            path + ("m",)))
                mom.append((rel(got_v[path].to(self.dev), v_new)[2],
                            path + ("v",)))

        loss, ties = self._reference_update(
            params, self.before["m"], self.before["v"],
            int(self.before["count"]), batch,
            dict(self.c, tie_choices=[c.to(self.dev) for c in choices]),
            visit)
        loss_err = abs(got_loss - loss) / abs(loss)
        upd_err, mom_err = max(e for e, _ in upd), max(e for e, _ in mom)
        glob = math.sqrt(whole[0] / whole[1]) if whole[1] > 0 else math.inf

        def worst(xs):
            top = sorted(xs, key=lambda x: -x[0])[:3]
            return [(p, round(e, 8)) for e, p in top]

        self.log(f"compared step: loss {got_loss!r} against {loss!r}; "
                 f"update rel err, worst tensor {upd_err:.6g} (all tensors "
                 f"as one vector {glob:.6g}), worst tensors {worst(upd)}; "
                 f"moments rel err, worst {mom_err:.6g}, worst tensors "
                 f"{worst(mom)}; near ties in the reference's routing "
                 f"(selection scores within {ref.TIE_GAP}, the compared "
                 f"step's choice taken): {ties}")
        return [("loss_rel_err", loss_err, lim["loss_rel_err"]),
                ("update_rel_err", upd_err, lim["update_rel_err"]),
                ("moments_rel_err", mom_err, lim["moments_rel_err"])]
