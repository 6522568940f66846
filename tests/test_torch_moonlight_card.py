"""On a card: one of Moonlight-16B-A3B's MoE layers at its published widths
(64 experts of width 1408, top-6, 2 shared experts, 8192 tokens) runs its
forward under ``torch.cuda.set_sync_debug_mode("error")``, which raises at
any call that waits for the device: routing, dispatch, kernel #1g's three
grouped products and their checks, the shared experts and the combine read
nothing back to the host.  The layer's output is held to the plain float32
reference, and a step's backward reads the offsets once.  The chunked
attention at the latent attention's shape skips the query rows a chunk
cannot reach and still gives the all-chunks loop's numbers."""
import contextlib

import pytest
import torch

from flash_oracle import oracle_bwd, oracle_fwd
from portbench.reference import moonlight as ref
from repro_torch.configs.base import get_config
from repro_torch.core.abft_gemm import ABFTConfig
from repro_torch.kernels import abft_matmul as kmm
from repro_torch import obs
from repro_torch.models import attention as tattn
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


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def test_chunk_skipping_at_the_latent_attention_shape():
    """The chunked FA-2 attention as Moonlight's training runs it (S 8192, 16
    heads, d_qk 192, d_v 128, chunks of 512, causal, positions the host
    knows) against the all-chunks loop on the card: o within 1e-6 of its
    largest magnitude, dq, dk and dv within 1e-5, and 46.875 % of the query
    rows x chunks skipped, forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    s, h, dqk, dv = 8192, 16, 192, 128
    q = torch.randn(1, s, h, 1, dqk, generator=gen, device="cuda")
    k = torch.randn(1, s, h, dqk, generator=gen, device="cuda")
    v = torch.randn(1, s, h, dv, generator=gen, device="cuda")
    do = torch.randn(1, s, h, 1, dv, generator=gen, device="cuda")
    pos = torch.arange(s, device="cuda")
    kw = dict(scale=dqk ** -0.5, softcap=None, causal=True, window=None,
              kc=512)
    want_o, want_lse = oracle_fwd(q, k, v, pos, pos, **kw)
    want = oracle_bwd(do, q, k, v, want_o, want_lse, pos, pos, **kw)
    rows = obs.counter("repro_flash_chunk_rows_total")
    before = {(kd, d): rows.value(kind=kd, direction=d)
              for kd in ("computed", "skipped") for d in ("fwd", "bwd")}
    live = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = tattn._sdpa_flash(*live, q_pos=pos, k_pos=pos, aligned=True,
                          **kw)
    o.backward(do)
    torch.cuda.synchronize()
    assert _rel(o, want_o) < 1e-6, _rel(o, want_o)
    for x, ref_grad in zip(live, want):
        assert _rel(x.grad, ref_grad) < 1e-5, _rel(x.grad, ref_grad)
    for d in ("fwd", "bwd"):
        skipped = rows.value(kind="skipped", direction=d) \
            - before[("skipped", d)]
        computed = rows.value(kind="computed", direction=d) \
            - before[("computed", d)]
        assert skipped / (skipped + computed) == 0.46875
