"""Entry points of the port: the flagship's decode step and the dry run.

Counterpart of the JAX package's ``__graft_entry__.py``:

- ``entry()`` -> (fn, example_args): the forward step of the flagship
  codec, one ILS (interleaved-stream) decode, A1 (`ops/ils_kernels.py::
  ils_decode`), whose int32 output is the original data's words.
- ``dryrun_multichip(n)``: the sharded paths on n ranks, each checking
  its results bit for bit (`parallel/dryrun.py`).

    python -m huffman_tpu_torch.graft_entry [N] [--backend gloo]
        [--device cpu] [--out-dir DIR]

runs the dry run on N ranks (8 by default, as ``python __graft_entry__.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .models import IlsCodec
from .ops.ils_kernels import ils_decode
from .parallel.dryrun import dryrun_multichip, main as _dryrun_main
from .utils import generate_redundant

__all__ = ["entry", "dryrun_multichip"]

# the JAX entry's section: 4 tiles of k=256 of generate_redundant(r=0.5)
ENTRY_K = 256
ENTRY_TILES = 4


def entry(*, device="cuda"):
    """The flagship's decode step and its example arguments, on ``device``
    (the card unless the caller asks for the CPU; raises without a card).

    The data is ``generate_redundant(4 * 256 * 1024, 0.5, seed=0)``, fitted
    and encoded by `IlsCodec` at k=256 into one section.  The arguments are
    the section's payload rows followed by ``w_cap`` zero slack rows
    ((rows, 1024) int32), the tiles' row starts ((4,) int32) and
    ``params = [snum, 0]`` (int32).  ``fn(payload_rows, row_starts, params)``
    returns the data's u32 words as (4 * 256 // 4, 1024) int32, the JAX
    ``fn``'s words.  ``params`` is accepted and not read: A1 takes each
    codeword's length from its table, so the schedule's ``snum`` does not
    reach it.  On the card each call launches A1 once."""
    data = generate_redundant(ENTRY_TILES * ENTRY_K * 1024, 0.5, seed=0)
    codec = IlsCodec.fit(data, k=ENTRY_K, device=device)
    (sec,) = codec.encode(data).sections
    p = sec.params
    dev = codec.device

    payload_rows = torch.cat([
        sec.payload,
        torch.zeros((p.w_cap, sec.payload.shape[1]), dtype=torch.int32,
                    device=dev)])
    row_starts = torch.from_numpy(p.row_starts[:-1].astype(np.int32)).to(dev)
    params = torch.tensor([p.snum, 0], dtype=torch.int32, device=dev)
    dec = codec.dec
    # the lengths the codec's own decode gives A1 (`ops/ils.py::
    # ils_decode_device`)
    max_len = max(codec.table.max_len_present, 1)
    min_len = max(codec.table.min_len, 1)

    def fwd(payload_rows, row_starts, params):
        return ils_decode(payload_rows, row_starts, dec, k=p.k, w_cap=p.w_cap,
                          n_tiles=p.n_tiles, max_len=max_len, min_len=min_len,
                          rot=p.rot)

    return fwd, (payload_rows, row_starts, params)


if __name__ == "__main__":
    raise SystemExit(_dryrun_main())
