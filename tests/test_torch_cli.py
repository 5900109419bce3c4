"""The port's command line against the JAX package's, on the CPU.

Both CLIs run in-process at `tests/test_cli.py`'s size (30,000 bytes,
``--k 8``): the port with ``--device cpu`` (its kernels' plain versions),
the JAX package in interpret mode.  The files must be equal byte for byte,
each package must decode the other's, and the printed lines must parse
the same way.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from huffman_tpu.cli import main as jmain
from huffman_tpu_torch.cli import main

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
FMT_ARGS = {"ils": ["--k", "8"], "htc1": [], "yamamoto": [], "seq": []}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    args = ["generate", "--size", "30000", "--redundancy", "0.5", "--seed", "3"]
    main([*args, "-o", str(d / "data.bin")])
    jmain([*args, "-o", str(d / "jdata.bin")])
    return d


def _encode(run, work, fmt, name, extra=()):
    out = work / name
    run(["encode", str(work / "data.bin"), "--format", fmt, "-o", str(out),
         *FMT_ARGS[fmt], *extra])
    return out


def _decode(run, src, out, fmt, extra=()):
    ref = ["--format", fmt] if fmt in ("yamamoto", "seq") else []
    run(["decode", str(src), "-o", str(out), *ref, *extra])
    return out.read_bytes()


def test_generate_matches_jax(work, capsys):
    data = (work / "data.bin").read_bytes()
    assert len(data) == 30000 and data == (work / "jdata.bin").read_bytes()


@pytest.mark.parametrize("fmt", ["ils", "htc1", "yamamoto", "seq"])
def test_encode_matches_jax_and_decodes_both_ways(work, fmt, capsys):
    data = (work / "data.bin").read_bytes()
    ours = _encode(main, work, fmt, f"t.{fmt}", CPU)
    printed = capsys.readouterr().out
    theirs = _encode(jmain, work, fmt, f"j.{fmt}")
    jprinted = capsys.readouterr().out
    assert ours.read_bytes() == theirs.read_bytes()
    # the same lines, up to the times
    strip = re.compile(r"Encode time:.*")
    assert strip.sub("", printed) == strip.sub("", jprinted)
    size = re.search(r"Compressed size: (\d+) bytes", printed).group(1)
    assert int(size) == ours.stat().st_size
    assert _decode(main, theirs, work / f"t_of_j.{fmt}", fmt, CPU) == data
    if fmt == "seq":
        # the JAX CLI's self-sync decode compiles for ~40 s on the CPU, and
        # test_cli.py runs it on these same bytes; its host walk reads the
        # port's file here
        from huffman_tpu.io.seqfmt import decode_seq

        out = np.asarray(decode_seq(ours.read_bytes(), device=False))
        assert out.tobytes() == data
    else:
        assert _decode(jmain, ours, work / f"j_of_t.{fmt}", fmt) == data
    line = capsys.readouterr().out
    assert re.match(r"Decompressed 30000 bytes in [\d.]+ ms \(", line)


@pytest.mark.parametrize("method", ["lut", "canonical", "twolevel", "pallas"])
def test_htc1_decode_methods(work, method):
    src = _encode(main, work, "htc1", "m.htc1", CPU)
    out = _decode(main, src, work / f"m_{method}.bin", "htc1",
                  ["--method", method, *CPU])
    assert out == (work / "data.bin").read_bytes()


def test_stream_encode_matches_jax(work, capsys):
    # two sections at k=8 (3 tiles, then the ragged last one tile, the
    # shapes of the whole-buffer encode), no halving: the JAX container
    # decodes, and the bytes must be equal
    data = (work / "data.bin").read_bytes()
    extra = ["--stream", "--section-bytes", "24576"]
    ours = _encode(main, work, "ils", "ts.ils", [*extra, *CPU])
    theirs = _encode(jmain, work, "ils", "js.ils", extra)
    assert ours.read_bytes() == theirs.read_bytes()
    for run, src, name, dev in ((main, theirs, "ts_of_j", CPU),
                                (jmain, ours, "js_of_t", [])):
        out = work / name
        run(["decode", str(src), "-o", str(out), "--stream", *dev])
        assert out.read_bytes() == data
    # the whole-buffer decode reads the streamed container too
    assert _decode(main, ours, work / "ts_whole.bin", "ils", CPU) == data
    printed = capsys.readouterr().out
    assert "section-streamed" in printed


@pytest.mark.parametrize("fmt", ["ils", "htc1", "yamamoto", "seq"])
def test_roundtrip_prints_pass(work, fmt, capsys):
    main(["roundtrip", str(work / "data.bin"), "--format", fmt,
          *FMT_ARGS[fmt], *CPU])
    out = capsys.readouterr().out
    assert "Verification:    PASS" in out
    assert re.search(r"Compressed size: \d+ bytes \([\d.]+%\)", out)


def test_decode_garbage_exits_with_the_jax_message(tmp_path, capsys):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"ZZZZ garbage")
    with pytest.raises(SystemExit) as got:
        main(["decode", str(bad), "-o", str(tmp_path / "o.bin"), *CPU])
    ours = capsys.readouterr().err
    with pytest.raises(SystemExit) as ref:
        jmain(["decode", str(bad), "-o", str(tmp_path / "j.bin")])
    theirs = capsys.readouterr().err
    assert got.value.code == ref.value.code == 1
    assert ours == theirs and ours.startswith("error: ")


def test_stream_needs_the_ils_format(work, capsys):
    with pytest.raises(SystemExit) as got:
        main(["encode", str(work / "data.bin"), "-o", str(work / "x"),
              "--stream", "--format", "htc1", *CPU])
    assert got.value.code == 1
    assert capsys.readouterr().err == "error: --stream requires --format ils\n"


def test_bench_on_the_cpu_prints_lines_that_parse(capsys):
    main(["bench", "--size", "16384", "--repeat", "1", "--warmup", "1",
          "--k", "8", *CPU])
    lines = capsys.readouterr().out.splitlines()
    pat = r"{}: ([\d.]+) GB/s \(median of 1, best ([\d.]+)\)"
    assert re.fullmatch(pat.format("encode"), lines[0])
    assert re.fullmatch(pat.format("decode"), lines[1])
    assert lines[2] == "verification: PASS"


def test_without_a_card_the_default_device_raises(work, monkeypatch):
    # --device defaults to cuda: with no card every subcommand that runs a
    # codec raises before any work, and none runs on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = str(work / "data.bin")
    out = work / "never.bin"
    for argv in (["encode", src, "-o", str(out)],
                 ["encode", src, "-o", str(out), "--stream"],
                 ["decode", str(_encode(main, work, "ils", "d.ils", CPU)),
                  "-o", str(out)],
                 ["roundtrip", src],
                 ["bench", "--size", "4096", "--repeat", "1"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
        assert not out.exists()


def test_module_entry_point_and_script():
    res = subprocess.run([sys.executable, "-m", "huffman_tpu_torch.cli",
                          "--help"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    for cmd in ("generate", "encode", "decode", "roundtrip", "bench"):
        assert cmd in res.stdout
    toml = (ROOT / "pyproject.toml").read_text()
    assert 'huffman-tpu-torch = "huffman_tpu_torch.cli:main"' in toml
    assert 'huffman-tpu = "huffman_tpu.cli:main"' in toml
