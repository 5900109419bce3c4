"""huffman_tpu_torch stands alone: no JAX, nothing of huffman_tpu, and its
entry points never run quietly on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import huffman_tpu_torch
from huffman_tpu_torch import GapArrayCodec, IlsCodec
from huffman_tpu_torch.ops import ils as tils
from huffman_tpu_torch.ops import ils_kernels as tk

PKG = Path(huffman_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "huffman_tpu", "jaxlib")


def test_imports_with_jax_and_huffman_tpu_blocked(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['huffman_tpu'] = None\n"
        "import huffman_tpu_torch, huffman_tpu_torch.models.ils_codec\n"
        "import huffman_tpu_torch.io, huffman_tpu_torch.ops.ils\n"
        "import huffman_tpu_torch.ops.cuda_build, huffman_tpu_torch.utils\n"
        "import numpy as np\n"
        "from huffman_tpu_torch.utils import generate_redundant\n"
        "d = generate_redundant(8 * 1024 + 5, 0.5, seed=1)\n"
        "c = huffman_tpu_torch.IlsCodec.fit(d, k=8, device='cpu')\n"
        "assert c.roundtrip_check(d)\n"
        "import huffman_tpu_torch.models.gap_codec, huffman_tpu_torch.ops.encode\n"
        "import huffman_tpu_torch.ops.gap_decode_kernels\n"
        "import huffman_tpu_torch.ops.gap_encode_kernels\n"
        "from huffman_tpu_torch import read_container, write_container\n"
        "g = huffman_tpu_torch.GapArrayCodec.fit(d, block_bytes=4096, "
        "device='cpu')\n"
        "out = g.decode(read_container(write_container(g.encode(d))))\n"
        "assert np.array_equal(out.numpy(), d)\n"
        "import huffman_tpu_torch.models.selfsync\n"
        "import huffman_tpu_torch.ops.selfsync_kernels\n"
        "from huffman_tpu_torch import decode_seq, decode_yamamoto, "
        "write_seq, write_yamamoto\n"
        "y = decode_yamamoto(write_yamamoto(d, g.table), device='cpu')\n"
        "assert np.array_equal(y.numpy(), d)\n"
        "s = decode_seq(write_seq(d, g.table), device='cpu')\n"
        "assert np.array_equal(s.numpy(), d)\n"
        "import huffman_tpu_torch.ops.decode\n"
        "import huffman_tpu_torch.ops.encode_map_kernels\n"
        "y = decode_yamamoto(write_yamamoto(d, g.table), method='lut', "
        "device='cpu')\n"
        "assert np.array_equal(y.numpy(), d)\n"
        "import huffman_tpu_torch.cli, huffman_tpu_torch.native\n"
        "import huffman_tpu_torch.io.refbin, huffman_tpu_torch.core.ils_ref\n"
        "from huffman_tpu_torch.core import huffman_lengths_unbounded, "
        "kraft_sum, TwoLevelTable, npref\n"
        "from huffman_tpu_torch.utils import generate_binomial, "
        "generate_single_symbol\n"
        "assert huffman_tpu_torch.native.available() in (True, False)\n"
        "huffman_tpu_torch.cli.main(['roundtrip', '--device', 'cpu', "
        "'--format', 'seq', sys.argv[1]])\n"
        "import huffman_tpu_torch.parallel, huffman_tpu_torch.utils.distributed\n"
        "import huffman_tpu_torch.parallel.dryrun\n"
        "from huffman_tpu_torch.ops import *\n"
        "from huffman_tpu_torch.parallel import data_mesh, "
        "make_ils_sharded_roundtrip\n"
        "from huffman_tpu_torch.ops.ils_kernels import ils_dec_tabs, "
        "ils_enc_tabs\n"
        "import torch\n"
        "mesh = data_mesh(device='cpu')\n"
        "assert mesh.backend == 'gloo' and not torch.distributed.is_initialized()\n"
        "step = make_ils_sharded_roundtrip(mesh, k=8, max_len=c.table.max_len_present, "
        "tiles_per_device=1, rot=True)\n"
        "x = torch.from_numpy(d[:8 * 1024].view(np.int32).reshape(-1, 1024).copy())\n"
        "out, ok = step(x, ils_enc_tabs(c.table, device='cpu'), "
        "ils_dec_tabs(c.table, device='cpu'))\n"
        "assert int(ok) == 1 and torch.equal(out, x)\n"
        "for name in huffman_tpu_torch.__all__:\n"
        "    getattr(huffman_tpu_torch, name)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in ('jax', 'jaxlib', 'huffman_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    src = tmp_path / "data.bin"
    src.write_bytes(np.arange(5000, dtype=np.uint8).tobytes())
    res = subprocess.run([sys.executable, "-c", code, str(src)], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Verification:    PASS" in res.stdout
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
                                       ROOT / "tools" / "fuzz_torch.py"]
))
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: {name}"


def test_fuzz_tool_runs_without_jax():
    # the soak's tool loads no JAX and nothing of huffman_tpu; it runs on
    # the card by default and raises without one
    code = (
        "import importlib.util, sys, torch\n"
        "spec = importlib.util.spec_from_file_location('fuzz_torch', "
        "'tools/fuzz_torch.py')\n"
        "fuzz = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(fuzz)\n"
        "assert fuzz.main(['--device', 'cpu', '--iters', '2', "
        "'--max-bytes', '4096']) == 0\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        fuzz.main([])\n"
        "    except RuntimeError as e:\n"
        "        assert \"device='cpu'\" in str(e)\n"
        "    else:\n"
        "        raise AssertionError('ran without a card')\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in ('jax', 'jaxlib', 'huffman_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "fuzz: 2 cases PASS" in res.stdout


def test_exported_names_match_the_jax_package():
    # the JAX package's exports resolve in the port, eagerly or at first
    # use; `parallel` lacks only JAX's PartitionSpec `P`
    import huffman_tpu
    import huffman_tpu.core
    import huffman_tpu.ops
    import huffman_tpu.parallel
    import huffman_tpu.utils.distributed
    import huffman_tpu_torch.core
    import huffman_tpu_torch.utils.distributed

    for jmod, tmod, less in (
        (huffman_tpu.core, huffman_tpu_torch.core, set()),
        (huffman_tpu.ops, huffman_tpu_torch.ops, set()),
        (huffman_tpu.parallel, huffman_tpu_torch.parallel, {"P"}),
        (huffman_tpu.utils.distributed, huffman_tpu_torch.utils.distributed,
         set()),
    ):
        assert set(jmod.__all__) - less <= set(tmod.__all__), tmod.__name__
        for name in set(jmod.__all__) - less:
            assert getattr(tmod, name) is not None, name
    assert "P" not in huffman_tpu_torch.parallel.__all__
    want = set(huffman_tpu.__all__)
    assert want <= set(huffman_tpu_torch.__all__)
    for name in want:
        obj = getattr(huffman_tpu_torch, name)
        if name in ("models", "ops", "io", "utils", "native", "constants",
                    "parallel"):
            assert obj.__name__ == f"huffman_tpu_torch.{name}", name
    assert huffman_tpu_torch.native.histogram is not None
    assert huffman_tpu_torch.build_two_level_table(
        huffman_tpu_torch.canonical_code_table(
            huffman_tpu_torch.huffman_lengths_unbounded(
                np.arange(256, dtype=np.int64) + 1), 16), 10) is not None
    with pytest.raises(AttributeError, match="no attribute 'mesh'"):
        huffman_tpu_torch.mesh


@pytest.mark.parametrize("kind", ["mixed", "skewed", "constant", "unaligned",
                                  "2-d view"])
def test_ops_histogram_equals_npref(kind):
    # ops.histogram keeps its int32 call form over `byte_counts`
    from huffman_tpu_torch.core import npref
    from huffman_tpu_torch.ops import histogram
    from huffman_tpu_torch.ops.histogram_kernels import byte_counts

    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 70_000, dtype=np.uint8)
    data[:1000] = 7
    if kind == "skewed":
        data = np.where(rng.random(70_000) < 0.9, 65 + (data & 3), data)
    elif kind == "constant":
        data[:] = 200
    t = torch.from_numpy(data)
    if kind == "unaligned":
        data, t = data[5:-3], t[5:-3]
    elif kind == "2-d view":
        t = t.view(350, 200)[:, 1:]
        data = np.ascontiguousarray(data.reshape(350, 200)[:, 1:])
    got = histogram(t)
    assert got.dtype == torch.int32 and got.shape == (256,)
    assert np.array_equal(got.numpy(), npref.histogram(data))
    assert np.array_equal(byte_counts(t).numpy(), npref.histogram(data))
    with pytest.raises(TypeError, match="uint8"):
        histogram(torch.zeros(4, dtype=torch.int32))


def test_cuda_mesh_raises_without_a_card():
    from huffman_tpu_torch.parallel import data_mesh, gather_shards

    if torch.cuda.is_available():
        # the mesh's own world-1 group: the default group stays unset, and
        # nothing is left behind for the next test
        mesh = data_mesh()
        try:
            assert (mesh.device.type, mesh.backend, mesh.size) == ("cuda", "nccl", 1)
            x = torch.arange(6, dtype=torch.int32, device=mesh.device)
            assert torch.equal(gather_shards(mesh, x), x)
            assert not torch.distributed.is_initialized()
        finally:
            mesh.close()
        # a CPU mesh after it runs over a gloo group of its own
        cpu = data_mesh(device="cpu")
        try:
            assert cpu.backend == "gloo"
            assert torch.equal(gather_shards(cpu, x.cpu()), x.cpu())
        finally:
            cpu.close()
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data_mesh(1, device="cuda")


def test_default_device_is_cuda_and_never_quietly_cpu():
    data = np.zeros(100, np.uint8)
    if torch.cuda.is_available():
        assert IlsCodec.fit(data).device.type == "cuda"
        assert GapArrayCodec.fit(data).device.type == "cuda"
        table = GapArrayCodec.fit(data).table
        blob = huffman_tpu_torch.write_yamamoto(data, table)
        assert huffman_tpu_torch.decode_yamamoto(blob).device.type == "cuda"
        seq = huffman_tpu_torch.write_seq(data, table)
        assert huffman_tpu_torch.decode_seq(seq).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IlsCodec.fit(data)
    table = IlsCodec.fit(data, device="cpu").table
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IlsCodec(table)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tils.ils_encode_device(data, table, tk.ils_enc_tabs(table, device="cpu"), k=8,
                               avg_bits=1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        tils.resolve_device("meta")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GapArrayCodec.fit(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GapArrayCodec(table)
    blob = huffman_tpu_torch.write_yamamoto(data, table)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        huffman_tpu_torch.decode_yamamoto(blob)
    seq = huffman_tpu_torch.write_seq(data, table)
    for selfsync in (True, False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            huffman_tpu_torch.decode_seq(seq, selfsync=selfsync)
    code, off, total_bits = huffman_tpu_torch.read_seq_header(seq)
    payload = np.frombuffer(seq, np.uint8, offset=off)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        huffman_tpu_torch.selfsync_decode_bytes(payload, total_bits, code)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        huffman_tpu_torch.selfsync_decode_words(np.zeros(2, np.uint32), 0,
                                                table)


def test_ctypes_signatures_match_sources():
    # ctypes checks neither the count nor the types of arguments: a
    # mismatch between a C entry, its declared argtypes and the wrapper's
    # call passes garbage to the kernel or crashes the process
    import ctypes
    import re

    from huffman_tpu_torch.ops import cuda_build

    ctype = {"ptr": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "int": ctypes.c_int}
    for name in cuda_build.KERNEL_SOURCES:
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
        assert set(entries) == set(cuda_build._SIGNATURES[name]), name
        for fn, params in entries.items():
            types = []
            for p in params.split(","):
                p = " ".join(p.split()[:-1]).replace("const ", "")
                types.append(ctype["ptr" if "*" in p else p])
            assert types == cuda_build._SIGNATURES[name][fn], fn

    # every module of the package that launches through `_lib`
    calls = {}
    trees = [ast.parse(p.read_text()) for p in sorted(PKG.rglob("*.py"))]
    launchers = [tree for tree in trees if any(
        isinstance(n, ast.Call) and getattr(n.func, "id", None) == "_lib"
        for n in ast.walk(tree))]
    assert len(launchers) >= 4
    for node in (n for tree in launchers for n in ast.walk(tree)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Call)
                and getattr(node.func.value.func, "id", None) == "_lib"):
            lib = node.func.value.args[0].value
            # the lengths pass hands its four envelopes over as *env
            calls[node.func.attr] = (lib, sum(
                4 if isinstance(a, ast.Starred) else 1 for a in node.args))
    assert {fn for _, fns in cuda_build._SIGNATURES.items() for fn in fns} \
        == set(calls)
    for fn, (lib, n_args) in calls.items():
        assert n_args == len(cuda_build._SIGNATURES[lib][fn]), fn


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    # no fallback: a missing compiler is an error, never the plain version
    from huffman_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("PATH", "")
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_kernels()


def test_kernel_resources_read_ptxas_logs(monkeypatch, tmp_path):
    # chip_smoke.py reports registers, shared memory and spills from the
    # ptxas output kept beside each library
    from huffman_tpu_torch.ops import cuda_build

    so = tmp_path / "libgap_encode.so"
    so.write_bytes(b"")
    so.with_suffix(".log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z19gap_row_pack_kernelPKj'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z19gap_row_pack_kernelPKj\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 1024 bytes smem, "
        "400 bytes cmem[0]\n")
    monkeypatch.setattr(cuda_build, "build_kernels", lambda: {"gap_encode": so})
    assert cuda_build.kernel_resources() == {"_Z19gap_row_pack_kernelPKj": {
        "registers": 40, "static_smem_bytes": 1024, "stack_bytes": 8,
        "spill_store_bytes": 4, "spill_load_bytes": 12}}
