"""The multi-device paths of the PyTorch port against the JAX package's
`parallel`, on the CPU.

The port runs as spawned ranks over gloo (`huffman_tpu_torch.parallel.
dryrun`, once per world size, each rank writing its local outputs to a
.npz file); the JAX package runs on the conftest's virtual CPU mesh at the
same number of devices, its Pallas kernels in interpret mode, at the JAX
suite's tiny shapes.  Every output must be equal bit for bit, rank by
rank: the collective histogram, the HTC1 block encode, decode and round
trip, the full-band ILS round trip, and the certified ILS section (params
and each rank's payload) and its decode.  The sharded ILS codec
(`IlsShardedCodec`) is held to the single-device `IlsCodec` on the whole
stream and to the benchmark's plain reference of the ILS1 container.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import huffman_tpu.parallel as jpar
from huffman_tpu.ops import dec_spec as jdec_spec
from huffman_tpu.ops import device_dec_table as jdevice_dec_table
from huffman_tpu.ops import device_enc_table as jdevice_enc_table
from huffman_tpu.ops.pallas.ils_kernels import ils_dec_tabs as jdec_tabs
from huffman_tpu.ops.pallas.ils_kernels import ils_enc_tabs as jenc_tabs
from benchmark.reference import ils as ref_ils
from huffman_tpu_torch import IlsCodec, read_ils_container
from huffman_tpu_torch import parallel as tpar
from huffman_tpu_torch.core.ils_ref import ILS_LANES, ils_n_win
from huffman_tpu_torch.ops import gap_encode_kernels as ge
from huffman_tpu_torch.ops import ils as tils
from huffman_tpu_torch.ops import ils_kernels as tk
from huffman_tpu_torch.parallel import dryrun as tdr
from huffman_tpu_torch.utils import generate_redundant
from huffman_tpu_torch.utils.distributed import init_multihost, is_multihost

# per world size, the shapes of the JAX suite (tests/test_parallel.py,
# tests/test_parallel_ils.py)
SIZES = {
    2: dict(ils_k=8, ils_tpd=2, ils_rot=False, ils_seed=7,
            cert_k=64, cert_tpd=1, cert_rots=(False,), cert_seed=17,
            gap_blocks=2, gap_block_bytes=4096, gap_seg_bits=1024,
            gap_methods=("lut",), gap_seed=2,
            codec_k=64, codec_tpd=3, codec_seed=5),
    4: dict(ils_k=8, ils_tpd=2, ils_rot=True, ils_seed=7,
            cert_k=64, cert_tpd=2, cert_rots=(False, True), cert_seed=17,
            gap_blocks=2, gap_block_bytes=2048, gap_seg_bits=128,
            gap_methods=("canonical", "lut"), gap_seed=1,
            codec_k=64, codec_tpd=2, codec_seed=6),
}
GAP_CASES = [(2, "lut"), (4, "canonical"), (4, "lut")]


def _cdiv(a, b):
    return -(-a // b)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> each rank's outputs, from one dry run per world size (a
    collective left waiting fails after 60 s instead of hanging)."""
    cache = {}

    def get(world):
        if world not in cache:
            out = tmp_path_factory.mktemp(f"world{world}")
            tdr.dryrun_multichip(world, backend="gloo", device="cpu",
                                 out_dir=out, timeout=60, **SIZES[world])
            cache[world] = [dict(np.load(out / f"rank{r}.npz"))
                            for r in range(world)]
        return cache[world]

    return get


@pytest.fixture(scope="module")
def jax_gap():
    """world -> the JAX package's HTC1 outputs on the same blocks."""
    cache = {}

    def get(world):
        if world in cache:
            return cache[world]
        s = SIZES[world]
        bb, seg_bits = s["gap_block_bytes"], s["gap_seg_bits"]
        data = tdr.gap_input(world, s["gap_blocks"], bb, s["gap_seed"])
        mesh = jpar.data_mesh(world)
        blocks = jnp.asarray(data)
        hist = np.asarray(jpar.sharded_histogram(mesh, blocks))
        table = tdr.fit_table(hist.astype(np.int64))
        spec = jdec_spec(table)
        enc, dec = jdevice_enc_table(table), jdevice_dec_table(table)
        max_words = _cdiv(bb * 16, 32)
        n_segs = _cdiv(max_words * 32, seg_bits)
        enc_out = jpar.make_sharded_encode(
            mesh, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs)(
                blocks, enc)
        words, _, gaps, counts = enc_out
        res = {"data": data, "hist": hist,
               "encode": [np.asarray(x) for x in enc_out]}
        for method in s["gap_methods"]:
            res[f"{method}_decoded"] = np.asarray(jpar.make_sharded_decode(
                mesh, spec=spec, seg_bits=seg_bits,
                max_count=int(np.asarray(counts).max()), out_size=bb,
                method=method)(words, gaps, counts, dec))
            out, ok = jpar.make_sharded_roundtrip(
                mesh, spec=spec, seg_bits=seg_bits, max_words=max_words,
                n_segs=n_segs, max_count=seg_bits // spec.min_len + 1,
                block_bytes=bb, method=method)(blocks, enc, dec)
            res[f"{method}_roundtrip"] = (np.asarray(out), int(ok))
        cache[world] = res
        return res

    return get


def _jax_tiles(data, world, k, tpd):
    return jnp.asarray(data.view(np.int32).reshape(world, tpd * (k // 4), 8, 128))


def _stacked(rs, key):
    return np.concatenate([r[key] for r in rs])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_histogram(ranks, jax_gap, world):
    want = jax_gap(world)["hist"]
    assert np.array_equal(want, np.bincount(jax_gap(world)["data"].reshape(-1),
                                            minlength=256))
    for r in ranks(world):
        assert r["gap_hist"].dtype == np.int32
        assert np.array_equal(r["gap_hist"], want)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_encode(ranks, jax_gap, world):
    words, total_bits, gaps, counts = jax_gap(world)["encode"]
    rs = ranks(world)
    assert np.array_equal(_stacked(rs, "gap_words").view(np.uint32), words)
    assert np.array_equal(_stacked(rs, "gap_total_bits"), total_bits)
    assert np.array_equal(_stacked(rs, "gap_gaps"), gaps)
    assert np.array_equal(_stacked(rs, "gap_counts"), counts)


@pytest.mark.parametrize("world,method", GAP_CASES)
def test_sharded_decode(ranks, jax_gap, world, method):
    want = jax_gap(world)[f"{method}_decoded"]
    assert np.array_equal(want, jax_gap(world)["data"])
    assert np.array_equal(_stacked(ranks(world), f"gap_{method}_decoded"), want)


@pytest.mark.parametrize("world,method", GAP_CASES)
def test_sharded_roundtrip(ranks, jax_gap, world, method):
    want, ok = jax_gap(world)[f"{method}_roundtrip"]
    rs = ranks(world)
    assert ok == 1 and all(int(r[f"gap_{method}_ok"]) == 1 for r in rs)
    assert np.array_equal(_stacked(rs, f"gap_{method}_roundtrip"), want)


@pytest.mark.parametrize("world", [2, 4])
def test_ils_sharded_roundtrip(ranks, world):
    s = SIZES[world]
    k, tpd = s["ils_k"], s["ils_tpd"]
    data = tdr.ils_input(world, k, tpd, s["ils_seed"])
    table = tdr.fit_table(np.bincount(data, minlength=256))
    step = jpar.make_ils_sharded_roundtrip(
        jpar.data_mesh(world), k=k, max_len=max(table.max_len_present, 1),
        tiles_per_device=tpd, rot=s["ils_rot"], interpret=True)
    out, ok = step(_jax_tiles(data, world, k, tpd), jenc_tabs(table),
                   jdec_tabs(table))
    assert int(ok) == 1
    want = np.asarray(out).reshape(world, -1, ILS_LANES)
    for d, r in enumerate(ranks(world)):
        assert int(r["ils_ok"]) == 1
        assert np.array_equal(r["ils_out"], want[d])


@pytest.fixture(scope="module")
def jax_certified():
    """rot -> the JAX package's certified section and its decode at
    D = 4, k = 64, 2 tiles a device (tests/test_parallel_ils.py)."""
    cache = {}

    def get(rot):
        if rot in cache:
            return cache[rot]
        s, world = SIZES[4], 4
        k, tpd = s["cert_k"], s["cert_tpd"]
        data = tdr.certified_input(world, k, tpd, s["cert_seed"])
        hist = np.bincount(data, minlength=256)
        table = tdr.fit_table(hist)
        avg_bits = float((hist * table.lengths.astype(np.int64)).sum()) / data.size
        mesh = jpar.data_mesh(world)
        ml = max(table.max_len_present, 1)
        sec = jpar.ils_sharded_certified_encode(
            mesh, _jax_tiles(data, world, k, tpd), jenc_tabs(table), k=k,
            max_len=ml, avg_bits=avg_bits, tiles_per_device=tpd, rot=rot,
            interpret=True)
        p = sec.params
        dec_fn = jpar.make_ils_sharded_decode(
            mesh, k=k, w_cap=p.w_cap, w_band=p.w_band, max_len=ml,
            min_len=max(table.min_len, 1), tiles_per_device=tpd, rot=rot,
            interpret=True)
        out = dec_fn(sec.payload_dev, sec.starts_dev,
                     jnp.asarray(np.array([p.snum, 0], np.int32)),
                     jnp.asarray(p.boffs.reshape(world, tpd, ils_n_win(k))),
                     jdec_tabs(table))
        cache[rot] = (sec, np.asarray(out).reshape(world, -1, ILS_LANES), data)
        return cache[rot]

    return get


@pytest.mark.parametrize("rot", [False, True])
def test_ils_sharded_certified_encode(ranks, jax_certified, rot):
    sec, _, _ = jax_certified(rot)
    p = sec.params
    key = f"cert_rot{int(rot)}_"
    pay = np.asarray(sec.payload_dev).reshape(4, -1, ILS_LANES)
    starts = np.asarray(sec.starts_dev)
    for d, r in enumerate(ranks(4)):
        for name in ("w_cap", "w_band", "snum", "w_tiles", "boffs"):
            assert np.array_equal(r[key + name], getattr(p, name)), name
        assert np.array_equal(r[key + "starts"], starts[d])
        # the rank's rows; the JAX compaction leaves rows past a device's
        # own unwritten (ROADMAP.md F5), which the port zeroes
        n = int(p.w_tiles.reshape(4, -1)[d].sum())
        assert r[key + "payload"].shape == pay[d].shape
        assert np.array_equal(r[key + "payload"][:n], pay[d][:n])
        assert not r[key + "payload"][n:].any()
    assert p.w_band <= p.w_cap // 2


@pytest.mark.parametrize("rot", [False, True])
def test_ils_sharded_decode(ranks, jax_certified, rot):
    _, want, data = jax_certified(rot)
    assert np.array_equal(want.reshape(-1).view(np.uint8), data)
    for d, r in enumerate(ranks(4)):
        assert np.array_equal(r[f"cert_rot{int(rot)}_decoded"], want[d])


@pytest.mark.parametrize("world", [2, 4])
def test_certified_section_equals_single_device(ranks, world):
    # the ranks' rows, without their slack, are the single-device payload
    s = SIZES[world]
    k, tpd = s["cert_k"], s["cert_tpd"]
    data = tdr.certified_input(world, k, tpd, s["cert_seed"])
    table = tdr.fit_table(np.bincount(data, minlength=256))
    rs = ranks(world)
    for rot in s["cert_rots"]:
        key = f"cert_rot{int(rot)}_"
        rows, _, p = tils.ils_encode_to_device(
            torch.from_numpy(data.view(np.int32).reshape(-1, ILS_LANES).copy()),
            tk.ils_enc_tabs(table, device="cpu"), k=k,
            avg_bits=float(rs[0][key + "avg_bits"]),
            max_len=table.max_len_present, rot=rot)
        assert (p.w_cap, p.w_band, p.snum) == (
            int(rs[0][key + "w_cap"]), int(rs[0][key + "w_band"]),
            int(rs[0][key + "snum"]))
        assert np.array_equal(p.boffs, rs[0][key + "boffs"])
        assert np.array_equal(p.w_tiles, rs[0][key + "w_tiles"])
        n = p.w_tiles.reshape(world, tpd).sum(axis=1)
        got = np.concatenate([r[key + "payload"][:m] for r, m in zip(rs, n)])
        assert np.array_equal(got, rows[: p.total_rows].numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_wrong_table_on_one_rank_fails_every_rank(ranks, world):
    assert [int(r["wrong_table_ok"]) for r in ranks(world)] == [0] * world


@pytest.mark.parametrize("world,case", [(2, "stride"), (2, "band"),
                                        (4, "stride"), (4, "band")])
def test_refused_section_raises_on_every_rank(ranks, world, case):
    msgs = {str(r[f"refused_{case}"]) for r in ranks(world)}
    assert len(msgs) == 1
    want = "stride_rows=4096 outside" if case == "stride" else "both anchors"
    assert want in msgs.pop()


def test_band_fault_input_violates_on_rank_zero_only():
    # the refusal above is data-dependent: alone, rank 0's tile violates
    # at both anchors and rank 1's passes at the laggard anchor
    viol = {}
    for rank in (0, 1):
        tile, table, k = tdr.band_fault_input(rank, SIZES[2]["gap_seed"])
        words = torch.from_numpy(tile.view(np.int32).reshape(-1, ILS_LANES).copy())
        stride = tils.stride_rows_for(k, table.max_len_present)
        for anchor in ("mu", "laggard"):
            viol[rank, anchor] = int(tk.ils_pack_certify(
                words, tils.ils_schedule_numer(4.5),
                tk.ils_enc_tabs(table, device="cpu"),
                k=k, stride_rows=stride, e_band=tils.fused_e_band(k),
                anchor=anchor)[4].max())
    assert viol == {(0, "mu"): 1, (0, "laggard"): 1, (1, "mu"): 1,
                    (1, "laggard"): 0}


@pytest.mark.parametrize("world", [2, 4])
def test_plain_versions_count_no_launch(ranks, world):
    for r in ranks(world):
        counts = {k: int(v) for k, v in r.items() if k.startswith("launches_")}
        assert set(counts) == {f"launches_{n}" for n in
                               {**tk.launch_counts(), **ge.launch_counts()}}
        assert not any(counts.values())


def _codec_whole(world):
    s = SIZES[world]
    return tdr.ils_input(world, s["codec_k"], s["codec_tpd"], s["codec_seed"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_codec_table_is_ilscodec_fit_of_the_whole(ranks, world):
    single = IlsCodec.fit(_codec_whole(world), device="cpu")
    for r in ranks(world):
        assert np.array_equal(r["codec_lengths"], single.table.lengths)
        assert int(r["codec_fit_k"]) == single.k


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(tdr.ROTATIONS))
def test_sharded_codec_rows_are_the_single_device_payload(ranks, world, name):
    # each rank's rows, in rank order, are IlsCodec's one section of the
    # whole stream at the same table, k and rotate
    whole = _codec_whole(world)
    rs = ranks(world)
    single = IlsCodec(IlsCodec.fit(whole, device="cpu").table,
                      k=SIZES[world]["codec_k"], rotate=tdr.ROTATIONS[name],
                      device="cpu")
    (sec,) = single.encode(whole).sections
    got = np.concatenate([r[f"codec_{name}_rows"] for r in rs])
    assert np.array_equal(got, sec.payload.numpy())
    assert {int(r[f"codec_{name}_w_band"]) for r in rs} == {sec.params.w_band}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_container_reads_back_on_one_process(ranks, world):
    whole = _codec_whole(world)
    rs = ranks(world)
    for name in tdr.ROTATIONS:
        blobs = {r[f"codec_{name}_container"].tobytes() for r in rs}
        assert len(blobs) == 1  # every rank holds the same container
        blob = blobs.pop()
        comp = read_ils_container(blob)
        assert len(comp.sections) == world
        out = IlsCodec(comp.table, device="cpu").decode(comp)
        assert np.array_equal(out.numpy(), whole)
        assert ref_ils.check([blob], [torch.from_numpy(whole)], 16, "cpu") == {
            "table_len_diff": 0, "container_byte_diff": 0, "format_faults": 0}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_codec_refuses_a_partial_tile_on_every_rank(ranks, world):
    # only rank 0's byte count is off; every rank raises before any pass
    msgs = [str(r["codec_refused"]) for r in ranks(world)]
    assert all("a positive multiple of k * 1024 = 65536" in m for m in msgs)
    assert f"rank 0 holds {SIZES[world]['codec_tpd'] * 65536 - 4}" in msgs[0]


@pytest.fixture(scope="module")
def mesh1():
    mesh = tpar.data_mesh(device="cpu")
    yield mesh
    mesh.close()


def test_shard_ils_payload_matches_jax_and_decodes(mesh1):
    # tests/test_parallel_ils.py's shape: 4 devices, k=8, 3 tiles each
    n_devices, k, tpd = 4, 8, 3
    data = generate_redundant(n_devices * tpd * k * ILS_LANES, 0.7, seed=8)
    codec = IlsCodec.fit(data, k=k, device="cpu")
    (sec,) = codec.encode(data).sections
    p = sec.params
    got = tpar.shard_ils_payload(sec.payload, p.row_starts, p.w_cap, n_devices)
    want = jpar.shard_ils_payload(sec.payload_u32(), p.row_starts, p.w_cap,
                                  n_devices)
    assert np.array_equal(got[0], want[0].reshape(n_devices, -1, ILS_LANES))
    assert np.array_equal(got[1], want[1])
    dec_fn = tpar.make_ils_sharded_decode(
        mesh1, k=k, w_cap=p.w_cap, w_band=p.w_band,
        max_len=codec.table.max_len_present, tiles_per_device=tpd, rot=p.rot)
    boffs = p.boffs.reshape(n_devices, tpd, -1)
    out = [dec_fn(torch.from_numpy(got[0][d]), torch.from_numpy(got[1][d]),
                  p.snum, torch.from_numpy(boffs[d]), codec.dec)
           for d in range(n_devices)]
    assert np.array_equal(torch.cat(out).numpy().view(np.uint8).reshape(-1), data)


@pytest.mark.parametrize("shard", [tpar.shard_ils_payload,
                                   jpar.shard_ils_payload])
def test_shard_payload_rejects_indivisible(shard):
    with pytest.raises(ValueError, match="not divisible"):
        shard(np.zeros((4, ILS_LANES), np.uint32), np.array([0, 2, 4]), 8, 4)


def test_sharded_decode_rejects_a_band_over_half_the_cap(mesh1):
    with pytest.raises(ValueError, match="w_band=9 outside"):
        tpar.make_ils_sharded_decode(mesh1, k=8, w_cap=16, w_band=9,
                                     max_len=8, tiles_per_device=1)


def test_world_one_mesh(mesh1):
    assert (mesh1.rank, mesh1.size, mesh1.device) == (0, 1, torch.device("cpu"))
    # the mesh owns its world-1 group; the process's default group stays unset
    assert mesh1.backend == "gloo" and mesh1.owns_group
    assert not torch.distributed.is_initialized()
    assert tpar.DATA_AXIS == "data" and tpar.Mesh is tpar.DataMesh
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        tpar.data_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="pass a group of 0 ranks"):
        tpar.data_mesh(0, device="cpu")
    assert tpar.data_mesh(1, device="cpu").size == 1
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert torch.equal(tpar.gather_shards(mesh1, x), x)
    data = generate_redundant(3 * 512, 0.5, seed=4).reshape(3, 512)
    hist = tpar.sharded_histogram(mesh1, torch.from_numpy(data))
    assert np.array_equal(hist.numpy(), np.bincount(data.reshape(-1),
                                                    minlength=256))
    # a tensor off the mesh's device never runs there quietly
    with pytest.raises(ValueError, match="mesh's device"):
        tpar.sharded_histogram(mesh1, torch.from_numpy(data).to("meta"))
    # no launcher configured: init_multihost leaves the world as it is
    init_multihost()
    assert not is_multihost()



def test_collectives_are_spans_and_counts(mesh1):
    from huffman_tpu_torch.utils import trace

    trace.drain()
    trace.enable()
    try:
        x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
        assert torch.equal(tpar.gather_shards(mesh1, x), x)
        assert torch.equal(tpar.gather_ragged(mesh1, x[:1]), x[:1])
        got = trace.drain()
    finally:
        trace.disable()
    colls = [(s["name"], {k: v for k, v in s["attrs"].items() if k != "counts"})
             for s in got["spans"] if s["name"].startswith("coll.")]
    # gather_shards: one all-gather of 24 B; gather_ragged: the sizes' 8 B
    # all-reduced, then the one padded row of 12 B gathered
    assert colls == [
        ("coll.all_gather", {"op": "all_gather", "bytes": 24, "world": 1}),
        ("coll.all_reduce", {"op": "all_reduce", "bytes": 8, "world": 1}),
        ("coll.all_gather", {"op": "all_gather", "bytes": 12, "world": 1})]
    c = got["counters"]
    assert (c["collectives.all_gather"], c["collectives.all_reduce"]) == (2, 1)
    assert c["collective_bytes"] == (24 + 24) + (8 + 8) + (12 + 12)


def test_init_multihost_reads_the_launchers_environment(monkeypatch):
    import torch.distributed as dist

    from huffman_tpu_torch.utils import distributed as tdist

    calls = []
    monkeypatch.setattr(tdist.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tdist.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    init_multihost(backend="gloo")  # nothing configured: a single process
    assert calls == []
    for key, val in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500"),
                     ("WORLD_SIZE", "4"), ("RANK", "3"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(key, val)
    init_multihost(backend="gloo", timeout=5)
    init_multihost("tcp://127.0.0.1:1234", 2, 1, backend="gloo")
    assert [a for a, _ in calls] == [("gloo",), ("gloo",)]
    assert calls[0][1]["init_method"] == "env://"
    assert (calls[0][1]["world_size"], calls[0][1]["rank"]) == (4, 3)
    assert calls[0][1]["timeout"].total_seconds() == 5
    assert calls[1][1] == {"init_method": "tcp://127.0.0.1:1234",
                           "world_size": 2, "rank": 1}
    assert dist.is_available()


@pytest.mark.parametrize("address,init_method", [
    ("127.0.0.1:29533", "tcp://127.0.0.1:29533"),  # jax.distributed's form
    ("localhost:1234", "tcp://localhost:1234"),
    ("tcp://127.0.0.1:1234", "tcp://127.0.0.1:1234"),
    ("file:///nonexistent/rendezvous", "file:///nonexistent/rendezvous"),
    ("env://", "env://"),
])
def test_init_multihost_takes_the_jax_call_form(monkeypatch, address,
                                                init_method):
    # init_multihost(coordinator_address, num_processes, process_id), as
    # the JAX package's; a host:port address becomes tcp://host:port
    from huffman_tpu_torch.utils import distributed as tdist

    calls = []
    monkeypatch.setattr(tdist.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tdist.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    init_multihost(address, 2, 1, backend="gloo")
    init_multihost(coordinator_address=address, num_processes=2,
                   process_id=1, backend="gloo")
    assert calls == 2 * [(("gloo",), {"init_method": init_method,
                                      "world_size": 2, "rank": 1})]


def test_sharded_histogram_takes_blocks_by_keyword(mesh1):
    # sharded_histogram(mesh, blocks=...): the JAX package's counts in both
    data = generate_redundant(4 * 512, 0.5, seed=6).reshape(4, 512)
    ref = np.bincount(data.reshape(-1), minlength=256)
    jhist = jpar.sharded_histogram(jpar.data_mesh(2), blocks=jnp.asarray(data))
    assert np.array_equal(np.asarray(jhist), ref)
    thist = tpar.sharded_histogram(mesh1, blocks=torch.from_numpy(data))
    assert thist.dtype == torch.int32
    assert np.array_equal(thist.numpy(), np.asarray(jhist))
