"""The paper's checksum algebra, ABFT SUMMA, the layer-level ABFT GEMM, the
FT context with its GF(2^8) option, and the α-β-γ performance model."""
from repro_torch.core.checksum import (
    checkpoint_matrix, encode, recover, encode_pytree, recover_pytree,
)
from repro_torch.core.encoding import (
    EncodingSpec, make_spec, encode_block_cols, encode_block_rows, encode_full,
    strip, split_full, block_views,
)
from repro_torch.core.detect import verify, locate_and_correct, VerifyResult
from repro_torch.core.recovery import recover_blocks, recoverable
from repro_torch.core.summa import (
    FailureEvent, MultiFailureEvent, BitflipEvent, abft_summa, summa,
    encode_operands,
)
from repro_torch.core.abft_gemm import (
    ABFTConfig, encode_weight, abft_matmul, verify_output, correct_output,
)
from repro_torch.core.context import FTContext
from repro_torch.core import model_perf
from repro_torch.core import galois
