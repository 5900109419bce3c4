"""Format constants shared with the JAX package (`huffman_tpu/constants.py`).

``MAX_CODEWORD_LENGTH = 16`` bounds every codeword, so four symbols always
fit one 64-bit pair of the ILS layout and every HTC1 gap fits ``GAP_BITS``.
The HTC1 container stores one u16 ``(count << GAP_BITS) | gap`` per segment,
so a segment's count must fit ``COUNT_BITS``.
"""

MAX_CODEWORD_LENGTH = 16
ALPHABET_SIZE = 256
UNIT_BITS = 32
SEG_BITS = 1024
REF_SEG_BITS = 128
GAP_BITS = 4  # bits per gap element (max_len <= 16 keeps gaps in [0, 15])
# bits per segment symbol count: a segment holds up to seg_bits / min_len
# codewords, so 4096 bits of 1-bit codes already overflow (ROADMAP.md F16)
COUNT_BITS = 12

# Uncompressed bytes per HTC1 block; blocks are encoded independently.
DEFAULT_BLOCK_BYTES = 1 << 24  # 16 MiB
# Block-local bit offsets are int32 in the format's metadata: keep
# block_bytes * MAX_CODEWORD_LENGTH <= 2**31.
MAX_BLOCK_BYTES = 1 << 27
