"""The training cell (``systems/ft_train.py``) through ``run.py --device
cpu``, at a test-sized copy of its configuration (the published block cut
to width 64, 8 experts top-2, 3 layers, 512 ids, two sequences of 48
tokens): the program passes the comparison, and fails it when the TF32
control takes its place or when the timed path is broken: one expert's
product skipped, the selection bias ignored, ``k_pe``'s RoPE left out, one
RMSNorm gain's update left out, or AdamW's moments never written back.
The limits are the test copy's own; the cell's are set from chip runs."""
import json

import pytest

from portbench.tests.helpers import make_tree, run_cell

CELL = "moonlight-16b-a3b-l5.train-8k-zipf"
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, intermediate_size=128, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, vocab_size=512,
            num_hidden_layers=3)
# at this size the program reads 0 - 1.4e-7 (loss), 7.0e-5 - 1.3e-4 (the
# worst tensor's update) and 4.1e-7 - 4.7e-7 (the worst moment) over three
# seeds, the control 2.2e-5 - 5.2e-5, 2.4e-2 - 3.3e-2 and 2.7e-3 - 4.5e-3
LIMITS = {"loss_rel_err": 1e-5, "update_rel_err": 1e-3,
          "moments_rel_err": 3e-5}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_tree(tmp_path_factory.mktemp("tree"))
    cfg = root / "portbench" / "configs" / "moonlight-16b-a3b-l5.json"
    c = json.loads(cfg.read_text())
    c.update(TINY, limits=LIMITS)
    cfg.write_text(json.dumps(c))
    mix = root / "portbench" / "traffic" / "train-8k-zipf.json"
    m = json.loads(mix.read_text())
    m.update(seq_len=48, sequences=2, batch_pool=4)
    mix.write_text(json.dumps(m))
    return root


def _verdict(root, **kw):
    rc, out, err = run_cell(root, CELL, **kw)
    assert rc == 0, err[-3000:]
    return out


def test_the_program_passes(root):
    out = _verdict(root, seconds=1.0)
    assert out["correct"] is True, out["checks"]
    assert {"ft_gemm_tflops", "setup_s"} <= set(out["metrics"])
    assert out["attempted"] >= 2 and out["failed"] == 0


def test_the_control_fails(root):
    out = _verdict(root, seconds=0.5, extra=["--control"])
    assert out["correct"] is False, out["checks"]


SKIP_AN_EXPERT = """
import torch as _torch
from repro_torch.kernels import abft_matmul as _kmm
_plain = _kmm.abft_matmul_grouped_plain
def _skipping(x, w, w_cs, offsets, wn, **kw):
    b = offsets.tolist()
    x = x.clone()
    x[b[1]:b[2]] = 0.0             # expert 1's product is never made
    return _plain(x, w, w_cs, offsets, wn, **kw)
_kmm.abft_matmul_grouped_plain = _skipping
"""

NO_SELECTION_BIAS = """
import torch as _torch
from repro_torch.models import moe as _moe
_route = _moe._route
def _unbiased(p, xf, s):
    return _route({**p, "bias": _torch.zeros_like(p["bias"])}, xf, s)
_moe._route = _unbiased
"""

NO_K_PE_ROPE = """
from repro_torch.models import attention as _attn
_rope = _attn.rope
def _rope_but_the_shared_key(x, positions, theta=10000.0):
    return x if x.shape[-2] == 1 else _rope(x, positions, theta)
_attn.rope = _rope_but_the_shared_key
"""

NORM_GAIN_LEFT = """
from repro_torch.train import step as _step
_update = _step.adamw_update_leaves
def _one_gain_left(grads, opt, params, cfg):
    new, new_opt, metrics = _update(grads, opt, params, cfg)
    # one RMSNorm gain of the first MoE layer keeps its value
    new["groups"][1][0]["b0"]["norm2"]["scale"] = \
        params["groups"][1][0]["b0"]["norm2"]["scale"]
    return new, new_opt, metrics
_step.adamw_update_leaves = _one_gain_left
"""

MOMENTS_NOT_WRITTEN = """
from repro_torch.train import step as _step
_update = _step.adamw_update_leaves
def _stale_moments(grads, opt, params, cfg):
    new, new_opt, metrics = _update(grads, opt, params, cfg)
    return new, dict(new_opt, m=opt["m"], v=opt["v"]), metrics
_step.adamw_update_leaves = _stale_moments
"""


@pytest.mark.parametrize("patch", [SKIP_AN_EXPERT, NO_SELECTION_BIAS,
                                   NO_K_PE_ROPE, NORM_GAIN_LEFT,
                                   MOMENTS_NOT_WRITTEN],
                         ids=["an-expert-skipped", "selection-bias-ignored",
                              "k_pe-rope-left-out", "a-norm-gain-left",
                              "moments-not-written"])
def test_a_broken_timed_path_is_not_correct(root, patch):
    out = _verdict(root, seconds=0.5, patch=patch)
    assert out["correct"] is False, out["checks"]
