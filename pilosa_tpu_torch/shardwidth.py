"""Shard geometry constants.

Reference: shardwidth/20.go:19 (`Exponent = 20`) and
fragment.go:50-63. The shard width is the number of columns per shard; the
reference selects the exponent 16..32 via build tags. Here it is selected via
the PILOSA_TPU_SHARD_WIDTH_EXPONENT environment variable (read once at import,
mirroring the compile-time nature of the Go build tag).

Device geometry: bitmap rows are stored as dense little-endian uint32 words,
`WORDS_PER_ROW = SHARD_WIDTH / 32` per (row, shard). TPU VPU lanes are 32-bit;
uint32 (not uint64) keeps popcount and bitwise ops native-width on TPU.
"""

import os

# The reference allows exponents 16..32 (shardwidth build tags). We cap at 30:
# device arithmetic traces range bounds as int32 (x64 stays off for TPU), so
# in-shard positions must stay below 2^31 — and a 2^30-column shard already
# exceeds any practical fragment (128 MiB dense per row). Exponent 31/32 would
# also let a single row's popcount wrap uint32.
SHARD_WIDTH_EXPONENT = int(os.environ.get("PILOSA_TPU_SHARD_WIDTH_EXPONENT", "20"))
if not 16 <= SHARD_WIDTH_EXPONENT <= 30:
    raise ValueError(
        f"PILOSA_TPU_SHARD_WIDTH_EXPONENT must be in [16, 30], got {SHARD_WIDTH_EXPONENT}"
    )

SHARD_WIDTH = 1 << SHARD_WIDTH_EXPONENT

# Number of 32-bit words that hold one row's bits within one shard.
WORDS_PER_ROW = SHARD_WIDTH // 32

# A container spans 2^16 bits (reference: roaring 2^16-wide containers,
# fragment.go:55-63 shardVsContainerExponent). Retained for the roaring
# interchange codec and block-checksum geometry.
CONTAINER_WIDTH = 1 << 16
CONTAINERS_PER_SHARD = SHARD_WIDTH // CONTAINER_WIDTH

# Anti-entropy block geometry (reference: fragment.go:81 HashBlockSize = 100).
HASH_BLOCK_SIZE = 100


def shard_of(col: int) -> int:
    """Shard that owns an absolute column id."""
    return col >> SHARD_WIDTH_EXPONENT


def pos_in_shard(col: int) -> int:
    """Column position within its shard."""
    return col & (SHARD_WIDTH - 1)


def pos(row_id: int, col_id: int) -> int:
    """Fragment-local bit position (reference: fragment.go:3090
    `pos = rowID*ShardWidth + columnID%ShardWidth`)."""
    return row_id * SHARD_WIDTH + (col_id & (SHARD_WIDTH - 1))
