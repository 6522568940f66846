"""The paper's checksum algebra, ABFT SUMMA and the layer-level ABFT GEMM."""
from repro_torch.core.checksum import checkpoint_matrix, encode, recover
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
