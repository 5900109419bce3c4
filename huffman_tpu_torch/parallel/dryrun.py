"""Multi-device dry run: the sharded paths on N ranks, each rank checking
its results bit for bit.

Counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``.
It starts N ranks (spawned processes; a CUDA context does not survive a
fork) and runs on each, on its shard of inputs made from seeds:

1. the full-band ILS round trip (`make_ils_sharded_roundtrip`, A5 + A1);
2. the certified ILS encode and its banded decode
   (`ils_sharded_certified_encode`, A2 + A3, then `make_ils_sharded_decode`,
   A1) on zeros | random | constant data, so the ranks' content differs;
3. the HTC1 block codec: the collective histogram, the table fitted from
   it, the sharded encode, decode and round trip.

Then each rank checks that a wrong decode table on rank 0 gives
``ok == 0`` on every rank, and that sections the fused tier refuses raise
the same ValueError on every rank: one over the stride budget, and one
whose emission band only rank 0's data violates.  Where
``out_dir`` is given, each rank writes its local outputs and its launch
counts to ``out_dir/rank{r}.npz``.

    python -m huffman_tpu_torch.parallel.dryrun N [--backend gloo]
        [--device cpu] [--out-dir DIR]

runs it (nccl on the cards by default; several ranks on one card need
gloo).  Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) the process
is one rank and spawns nothing.
"""

from __future__ import annotations

import argparse
import os
import socket
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import (
    data_mesh,
    gather_shards,
    ils_sharded_certified_encode,
    make_ils_sharded_decode,
    make_ils_sharded_roundtrip,
    make_sharded_decode,
    make_sharded_encode,
    make_sharded_roundtrip,
    sharded_histogram,
)
from .mesh import DataMesh, all_reduce
from ..core import canonical_code_table, npref, package_merge_lengths
from ..core.ils_ref import ILS_LANES, ils_n_win
from ..ops import gap_encode_kernels as ge
from ..ops import ils_kernels as tk
from ..ops.tables import dec_spec, device_dec_table, device_enc_table
from ..utils import generate_redundant
from ..utils.distributed import init_multihost

__all__ = ["dryrun_multichip", "run_paths", "ils_input", "certified_input",
           "gap_input", "band_fault_input", "fit_table", "DEFAULT_SIZES"]

# the JAX dry run's sizes
DEFAULT_SIZES = dict(
    ils_k=8, ils_tpd=2, ils_rot=True, ils_seed=0,
    cert_k=512, cert_tpd=1, cert_rots=(False,), cert_seed=2,
    gap_blocks=2, gap_block_bytes=2048, gap_seg_bits=128,
    gap_methods=("lut",), gap_seed=1,
)
# the ILS kernels the paths must launch on a CUDA mesh
ILS_WRAPPERS = ("ils_pack", "ils_decode", "ils_pack_certify", "ils_compact")
# and the HTC1 encode kernels (the sharded encode)
GAP_WRAPPERS = ("gap_row_pack", "gap_row_meta", "gap_place_bits")


def fit_table(hist: np.ndarray):
    """The dry run's code table: package-merge lengths of a histogram,
    at most 16 bits."""
    return canonical_code_table(package_merge_lengths(hist, 16), 16)


def ils_input(n_devices: int, k: int, tpd: int, seed: int) -> np.ndarray:
    """The full-band round trip's bytes: tpd tiles a rank of
    generate_redundant(r=0.5)."""
    return generate_redundant(n_devices * tpd * k * ILS_LANES, 0.5, seed=seed)


def certified_input(n_devices: int, k: int, tpd: int, seed: int) -> np.ndarray:
    """The certified path's bytes: zeros | uniform random | 'A', a quarter,
    a half and a quarter of tpd tiles a rank."""
    n = n_devices * tpd * k * ILS_LANES
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.zeros(n // 4, np.uint8),
        rng.integers(0, 256, n // 2).astype(np.uint8),
        np.full(n - n // 4 - n // 2, 65, np.uint8),
    ])


def gap_input(n_devices: int, blocks: int, block_bytes: int,
              seed: int) -> np.ndarray:
    """The HTC1 path's blocks: (n_devices * blocks, block_bytes) of
    generate_redundant(r=0.5)."""
    n_blocks = n_devices * blocks
    return generate_redundant(n_blocks * block_bytes, 0.5, seed=seed).reshape(
        n_blocks, block_bytes)


def _cdiv(a, b):
    return -(-a // b)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _local_words(mesh: DataMesh, data: np.ndarray, k: int, tpd: int):
    """This rank's tiles of ``data`` as (tpd * k//4, 1024) int32 words on
    its device."""
    tile = k * ILS_LANES
    mine = data[mesh.rank * tpd * tile: (mesh.rank + 1) * tpd * tile]
    return torch.from_numpy(mine.view(np.int32).reshape(-1, ILS_LANES)
                            .copy()).to(mesh.device)


def _gathered_bytes(mesh: DataMesh, local: torch.Tensor) -> np.ndarray:
    got = gather_shards(mesh, local.contiguous()).cpu().numpy()
    return got.view(np.uint8).reshape(-1)


def _ils_roundtrip(mesh, out, s):
    k, tpd = s["ils_k"], s["ils_tpd"]
    data = ils_input(mesh.size, k, tpd, s["ils_seed"])
    table = fit_table(npref.histogram(data))
    step = make_ils_sharded_roundtrip(
        mesh, k=k, max_len=max(table.max_len_present, 1),
        tiles_per_device=tpd, rot=s["ils_rot"])
    dev = mesh.device
    local = _local_words(mesh, data, k, tpd)
    got, ok = step(local, tk.ils_enc_tabs(table, device=dev),
                   tk.ils_dec_tabs(table, device=dev))
    _check(int(ok) == 1, "sharded ILS round trip verification failed")
    _check(np.array_equal(_gathered_bytes(mesh, got), data),
           "sharded ILS round trip: ordered gather mismatch")
    out.update(ils_out=got.cpu().numpy(), ils_ok=int(ok))


def _certified(mesh, out, s):
    k, tpd = s["cert_k"], s["cert_tpd"]
    data = certified_input(mesh.size, k, tpd, s["cert_seed"])
    hist = npref.histogram(data)
    table = fit_table(hist)
    ml = max(table.max_len_present, 1)
    avg_bits = float((hist * table.lengths.astype(np.int64)).sum()) / data.size
    dev = mesh.device
    local = _local_words(mesh, data, k, tpd)
    enc, dec = tk.ils_enc_tabs(table, device=dev), tk.ils_dec_tabs(table, device=dev)
    for rot in s["cert_rots"]:
        sec = ils_sharded_certified_encode(
            mesh, local, enc, k=k, max_len=ml, avg_bits=avg_bits,
            tiles_per_device=tpd, rot=rot)
        p = sec.params
        _check(p.w_band <= p.w_cap // 2, "certified band wider than w_cap/2")
        dec_fn = make_ils_sharded_decode(
            mesh, k=k, w_cap=p.w_cap, w_band=p.w_band, max_len=ml,
            min_len=max(table.min_len, 1), tiles_per_device=tpd, rot=rot)
        boffs = p.boffs.reshape(mesh.size, tpd, ils_n_win(k))[mesh.rank]
        got = dec_fn(sec.payload_dev, sec.starts_dev, p.snum,
                     torch.from_numpy(boffs).to(dev), dec)
        _check(torch.equal(got, local), "certified sharded pipeline mismatch")
        out.update({f"cert_rot{int(rot)}_{key}": val for key, val in dict(
            payload=sec.payload_dev.cpu().numpy(), decoded=got.cpu().numpy(),
            starts=sec.starts_dev.cpu().numpy(), w_tiles=p.w_tiles,
            boffs=p.boffs, w_cap=p.w_cap, w_band=p.w_band, snum=p.snum,
            avg_bits=avg_bits).items()})


def _gap(mesh, out, s):
    nb, bb, seg_bits = s["gap_blocks"], s["gap_block_bytes"], s["gap_seg_bits"]
    data = gap_input(mesh.size, nb, bb, s["gap_seed"])
    dev = mesh.device
    local = torch.from_numpy(data[mesh.rank * nb: (mesh.rank + 1) * nb]).to(dev)
    hist = sharded_histogram(mesh, local).cpu().numpy()
    _check(np.array_equal(hist, np.bincount(data.reshape(-1), minlength=256)),
           "sharded histogram differs from the whole input's")
    table = fit_table(hist.astype(np.int64))
    spec = dec_spec(table)
    enc = device_enc_table(table, device=dev)
    dec = device_dec_table(table, device=dev)
    max_words = _cdiv(bb * 16, 32)
    n_segs = _cdiv(max_words * 32, seg_bits)
    words, total_bits, gaps, counts = make_sharded_encode(
        mesh, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs)(local, enc)
    max_count = int(all_reduce(mesh, counts.amax(), "max"))
    out.update(gap_hist=hist, gap_words=words.cpu().numpy(),
               gap_total_bits=total_bits.cpu().numpy(),
               gap_gaps=gaps.cpu().numpy(), gap_counts=counts.cpu().numpy())
    for method in s["gap_methods"]:
        got = make_sharded_decode(mesh, spec=spec, seg_bits=seg_bits,
                                  max_count=max_count, out_size=bb,
                                  method=method)(words, gaps, counts, dec)
        _check(torch.equal(got, local), f"sharded decode ({method}) mismatch")
        step = make_sharded_roundtrip(
            mesh, spec=spec, seg_bits=seg_bits, max_words=max_words,
            n_segs=n_segs, max_count=seg_bits // spec.min_len + 1,
            block_bytes=bb, method=method)
        got2, ok = step(local, enc, dec)
        _check(int(ok) == 1, f"sharded gap-array round trip ({method}) failed")
        _check(np.array_equal(_gathered_bytes(mesh, got2), data.reshape(-1)),
               f"sharded gap-array round trip ({method}): gather mismatch")
        out.update({f"gap_{method}_decoded": got.cpu().numpy(),
                    f"gap_{method}_roundtrip": got2.cpu().numpy(),
                    f"gap_{method}_ok": int(ok)})


def _refused(mesh, out, key, data_local, enc, **kw):
    """Records the ValueError that the certified encode must raise."""
    try:
        ils_sharded_certified_encode(mesh, data_local, enc, **kw)
    except ValueError as e:
        out[key] = str(e)
        return
    raise AssertionError(f"{key}: the certified encode did not refuse")


def _faults(mesh, out, s):
    dev = mesh.device
    # a wrong decode table on rank 0 alone: the MIN gives ok == 0 everywhere
    nb, bb, seg_bits = s["gap_blocks"], s["gap_block_bytes"], s["gap_seg_bits"]
    data = gap_input(mesh.size, nb, bb, s["gap_seed"])
    table = fit_table(npref.histogram(data))
    wrong = fit_table(npref.histogram(data ^ 0x55))
    spec = dec_spec(table)
    max_words = _cdiv(bb * 16, 32)
    step = make_sharded_roundtrip(
        mesh, spec=spec, seg_bits=seg_bits, max_words=max_words,
        n_segs=_cdiv(max_words * 32, seg_bits),
        max_count=seg_bits // spec.min_len + 1, block_bytes=bb)
    local = torch.from_numpy(data[mesh.rank * nb: (mesh.rank + 1) * nb]).to(dev)
    dec = device_dec_table(wrong if mesh.rank == 0 else table, device=dev)
    _, ok = step(local, device_enc_table(table, device=dev), dec)
    _check(int(ok) == 0, "a wrong table on rank 0 still gave ok == 1")
    out["wrong_table_ok"] = int(ok)

    # refused before any launch: the stride over the fused budget
    k = 8192
    zeros = torch.zeros((k // 4, ILS_LANES), dtype=torch.int32, device=dev)
    enc = tk.ils_enc_tabs(table, device=dev)
    _refused(mesh, out, "refused_stride", zeros, enc, k=k, max_len=16,
             avg_bits=8.0, tiles_per_device=1)
    # refused on rank 0's data alone (`band_fault_input`); the other
    # ranks' tiles pass at the laggard anchor
    tile, table, k = band_fault_input(mesh.rank, s["gap_seed"])
    words = torch.from_numpy(tile.view(np.int32).reshape(-1, ILS_LANES)
                             .copy()).to(dev)
    _refused(mesh, out, "refused_band", words, tk.ils_enc_tabs(table, device=dev),
             k=k, max_len=max(table.max_len_present, 1), avg_bits=4.5,
             tiles_per_device=1)


def band_fault_input(rank: int, seed: int, k: int = 512):
    """One tile of k=512 for `rank` and the code table of the fault check:
    on rank 0 half of each row's lanes read zeros and the other half
    uniform bytes, so its streams drift apart beyond the fused pass's
    emission band at both anchors; any other rank gets
    generate_redundant(r=0.5).  Returns (bytes, table, k)."""
    rng = np.random.default_rng(seed)
    tile = np.zeros((k // 4, ILS_LANES * 4), np.uint8)
    half = ILS_LANES * 2
    if rank == 0:
        tile[:, half:] = rng.integers(0, 256, (k // 4, half), dtype=np.uint8)
    else:
        tile[:] = generate_redundant(tile.size, 0.5, seed=seed).reshape(
            tile.shape)
    table = fit_table(npref.histogram(np.concatenate([
        np.zeros(tile.size // 2, np.uint8),
        rng.integers(0, 256, tile.size // 2, dtype=np.uint8)])))
    return tile.reshape(-1), table, k


def run_paths(mesh: DataMesh, sizes: dict | None = None) -> dict:
    """Every path of the dry run on this rank of ``mesh``, then the fault
    checks; returns its local outputs and the paths' launch counts (a dict
    of arrays and numbers).  Raises on any mismatch; on a CUDA mesh, also
    where the paths launched none of A1, A2, A3 or A5, or of B4b-B4d."""
    s = {**DEFAULT_SIZES, **(sizes or {})}
    tk.reset_launch_counts()
    ge.reset_launch_counts()
    out: dict = {"rank": mesh.rank, "size": mesh.size}
    _ils_roundtrip(mesh, out, s)
    _certified(mesh, out, s)
    _gap(mesh, out, s)
    launches = {**tk.launch_counts(), **ge.launch_counts()}
    if mesh.device.type == "cuda":
        missing = [name for name in ILS_WRAPPERS + GAP_WRAPPERS
                   if not launches[name]]
        _check(not missing, f"kernels not launched: {missing}")
    out.update({f"launches_{name}": c for name, c in launches.items()})
    _faults(mesh, out, s)
    return out


def _rank_main(rank, n_devices, coordinator_address, backend, device,
               out_dir, timeout, sizes, local_rank=None):
    local_rank = rank if local_rank is None else local_rank
    init_multihost(coordinator_address, n_devices, rank,
                   local_rank=local_rank, backend=backend, timeout=timeout)
    if device == "cuda" and backend != "nccl":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    try:
        mesh = data_mesh(n_devices, device=device)
        out = run_paths(mesh, sizes)
        if out_dir is not None:
            np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **out)
        if mesh.rank == 0:
            print(f"dryrun_multichip: {mesh.size} ranks on {device} "
                  f"({backend}), ILS full band ({out['ils_out'].shape[0]} "
                  f"rows a rank) + certified pipeline + gap-array blocks "
                  f"bit-exact", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dryrun_multichip(n_devices: int, *, backend: str = "nccl",
                     device: str = "cuda", out_dir=None, timeout: float = 300,
                     **sizes) -> None:
    """Runs the dry run on ``n_devices`` spawned ranks (`run_paths` on
    each) and returns when all have passed; raises where any rank failed
    (the others are stopped).  ``sizes`` override `DEFAULT_SIZES`;
    ``timeout`` (seconds) bounds every collective."""
    import torch.multiprocessing as mp

    unknown = set(sizes) - set(DEFAULT_SIZES)
    if unknown:
        raise TypeError(f"unknown sizes: {sorted(unknown)}")
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
    mp.start_processes(
        _rank_main, nprocs=n_devices, join=True, start_method="spawn",
        args=(n_devices, f"127.0.0.1:{_free_port()}", backend, device,
              None if out_dir is None else str(out_dir), timeout, sizes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-dir")
    args = ap.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        _rank_main(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                   None, args.backend, args.device, args.out_dir, 300, {},
                   int(os.environ.get("LOCAL_RANK", 0)))
    else:
        dryrun_multichip(args.n_devices, backend=args.backend,
                         device=args.device, out_dir=args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
