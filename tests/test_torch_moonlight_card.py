"""On a card: one of Moonlight-16B-A3B's MoE layers at its published widths
(64 experts of width 1408, top-6, 2 shared experts, 8192 tokens) runs its
forward under ``torch.cuda.set_sync_debug_mode("error")``, which raises at
any call that waits for the device: routing, dispatch, kernel #1g's three
grouped products and their checks, the shared experts and the combine read
nothing back to the host.  The layer's output is held to the plain float32
reference, and a step's backward reads the offsets once."""
import contextlib

import pytest
import torch

from portbench.reference import moonlight as ref
from repro_torch.configs.base import get_config
from repro_torch.core.abft_gemm import ABFTConfig
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tf

pytestmark = pytest.mark.gpu


@contextlib.contextmanager
def _no_sync():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_a_published_width_moe_layer_reads_nothing_back(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: kernel #1g has no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("moonlight-16b-a3b")
    spec = tf._moe_spec(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = tmoe.moe_init(gen, spec)
    p["bias"].copy_(0.05 * torch.randn(spec.n_experts, generator=gen,
                                       device="cuda"))
    x = torch.randn(1, 8192, cfg.d_model, generator=gen, device="cuda")
    abft = ABFTConfig(mode="correct", backend="cuda")
    tmoe.moe_apply(p, x, spec, abft, layer=1)      # builds, plans, warms
    torch.cuda.synchronize()
    before = kmm.grouped_launches
    live = {k: (v.detach().requires_grad_(k != "bias")
                if isinstance(v, torch.Tensor) else v) for k, v in p.items()}
    with _no_sync():
        y, aux = tmoe.moe_apply(live, x, spec, abft, layer=1)
    torch.cuda.synchronize()
    assert kmm.grouped_launches - before == 3
    rcfg = dict(n_routed_experts=spec.n_experts,
                num_experts_per_tok=spec.top_k,
                routed_scaling_factor=spec.routed_scale)
    want, want_aux, load, _ = ref._moe(p, x, rcfg)
    err = float((y - want).abs().max() / want.abs().max())
    assert err < 1e-4, err
    assert torch.allclose(aux, want_aux, rtol=1e-4)
    # the backward's one host read: the offsets, for the per-expert
    # products of the operand gradients
    reads = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda t: reads.append(t.numel()) or real(t))
    (y.square().sum() + aux).backward()
    torch.cuda.synchronize()
    assert len(reads) == 1
    assert live["gate"].grad is not None and live["down"].grad is not None
