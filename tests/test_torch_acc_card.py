"""On a card: kernel #2's fp32 tensor-core route (``abft_wgmma.cuh``'s TMA
ring and wgmma over the operands' 3xTF32 planes, ``csrc/tf32_split.cu``) at
the SUMMA's block sizes, in place as the SUMMA calls it, against its plain
version.  C_in and the carried state come from two earlier steps on the
kernel, with |C_in| around 1e3: a late step's large running sum beside one
step's partials.  The split kernel against its plain version, bit for bit,
on what the SUMMA hands it: an 8 x 8 stack of 3000^2 blocks sliced as A's
and B's panels, and a ragged, misaligned batch (its scalar path)."""
import pytest
import torch

from repro_torch.kernels import abft_matmul as kmm
from repro_torch.kernels import ops
from torch_port_helpers import within_rtol

pytestmark = pytest.mark.gpu

NO_CARD = ("needs a CUDA card and nvcc: the CUDA kernel has no CPU mode "
           "(chip_smoke.py runs this comparison on the H100)")

@pytest.mark.parametrize("m", [3000, 3072])
def test_wgmma_route_matches_plain_in_place(m):
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(m)

    def rnd(scale=1.0):
        return scale * torch.randn((m, m), generator=g, device="cuda")

    wm = ops.kernel_weights(m, device="cuda")
    wn = ops.kernel_weights(m, device="cuda").T.contiguous()
    c = rnd(1e3)
    state = tuple(x.contiguous() for x in ops.tile_checksums(c, wm, wn, 128,
                                                            128))
    for _ in range(2):                       # two earlier steps
        c, *state, _ = kmm.abft_matmul_acc_cuda(rnd(), rnd(), c, *state, wm,
                                                wn)
    a, b = rnd(), rnd()
    planes = kmm.tf32_planes(a, b)
    want = kmm.abft_matmul_acc_plain(a, b, c, *state, wm, wn)
    l0, w0 = kmm.acc_launches, kmm.acc_wgmma_launches
    runs = []
    for _ in range(2):
        ins = (c.clone(), *(x.clone() for x in state))
        runs.append(kmm.abft_matmul_acc_cuda(a, b, *ins, wm, wn, out=ins,
                                             planes=planes))
        assert runs[-1][0].data_ptr() == ins[0].data_ptr()
    torch.cuda.synchronize()
    assert kmm.last_acc_route["mainloop"] == "wgmma"
    assert kmm.acc_launches - l0 == kmm.acc_wgmma_launches - w0 == 2
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    got = runs[0]
    assert within_rtol(got[0], want[0])
    assert float(got[3][..., 4:6].abs().max()) == 0.0
    assert torch.equal(got[3][..., :4], want[3][..., :4])
    # a flipped C_in element: located and repaired as the plain version does
    bad = c.clone()
    bad[1234 % m, 777] += 1e4
    got = kmm.abft_matmul_acc_cuda(a, b, bad, *state, wm, wn, planes=planes)
    want = kmm.abft_matmul_acc_plain(a, b, bad, *state, wm, wn)
    torch.cuda.synchronize()
    assert float(got[3][..., 1].sum()) == 1.0
    assert torch.equal(got[3][..., :4], want[3][..., :4])
    assert within_rtol(got[0], want[0])


# fp32 bit patterns: ties at half a TF32 ulp (up, down, odd, subnormal), the
# zeros, a subnormal (inf and NaN aside: the card's NaN bits differ)
SPECIALS = (0x3f801000, 0xbf801000, 0x3f803000, 0x00001000, 0, 0x80000000,
            0x000116c2)


@pytest.mark.parametrize("case", ["a_panel", "b_panel", "ragged"])
@pytest.mark.parametrize("transpose", [False, True])
def test_split_kernel_matches_plain_bit_for_bit(case, transpose):
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    g = torch.Generator(device="cuda").manual_seed(11)
    if case == "ragged":          # rows of 1001 off a 16-byte boundary
        x = 1e3 * torch.randn((3, 517, 1003), generator=g, device="cuda")
        blk = x[..., 1:1002]
    else:                         # the SUMMA's 8 x 8 blocks of 3000^2
        x = 1e3 * torch.randn((8, 8, 3000, 3000), generator=g, device="cuda")
        bits = torch.tensor([b - (1 << 32) if b >> 31 else b
                             for b in SPECIALS], dtype=torch.int32).cuda()
        x.view(torch.int32)[5, 2, 7, :len(SPECIALS)] = bits
        x.view(torch.int32)[5, 2, :len(SPECIALS), 11] = bits
        blk = x[:, 2] if case == "a_panel" else x[5]
    n0 = kmm.acc_split_launches
    got = kmm.tf32_split_cuda(blk, transpose=transpose)
    want = kmm.tf32_split_plain(blk, transpose=transpose)
    torch.cuda.synchronize()
    assert kmm.acc_split_launches - n0 == 1
    for u, v in zip(got, want):
        assert u.shape == v.shape
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
