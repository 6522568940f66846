"""``tools/torch_profile_steps.py`` files each kernel of the port under its
own group by its whole name: kernel #2's ``acc_mma_kernel`` is not kernel
#1's ``mma_kernel``."""
import importlib.util
import pathlib

import pytest

TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "torch_profile_steps.py"


@pytest.fixture(scope="module")
def group_of():
    spec = importlib.util.spec_from_file_location("torch_profile_steps", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.group_of


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::mma_kernel<float, 128, 128>(float const*)",
     "kernel1_abft_matmul"),
    ("void (anonymous namespace)::splitk_partial<float, 16>(float const*)",
     "kernel1_abft_matmul"),
    ("void (anonymous namespace)::acc_mma_kernel<float, 128, 128>(float "
     "const*)", "kernel2_abft_matmul_acc"),
    ("void (anonymous namespace)::abft_matmul_acc_kernel<float, float, 32, "
     "64>(float const*)", "kernel2_abft_matmul_acc"),
    ("checksum_encode_kernel<float>", "kernel3_checksum_encode"),
    ("void flash_kernel<float, 64>(Params)", "kernel4_flash"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8",
     "library_gemm"),
    ("Memcpy DtoD (Device -> Device)", "copies"),
    ("void at::native::elementwise_kernel<128, 2>", "other"),
])
def test_kernels_are_grouped_by_whole_name(group_of, name, group):
    assert group_of(name) == group
