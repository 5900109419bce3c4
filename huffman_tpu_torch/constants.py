"""Format constants shared with the JAX package (`huffman_tpu/constants.py`).

Only what the ILS slice needs.  ``MAX_CODEWORD_LENGTH = 16`` bounds every
codeword, so four symbols always fit one 64-bit pair of the ILS layout.
"""

MAX_CODEWORD_LENGTH = 16
ALPHABET_SIZE = 256
