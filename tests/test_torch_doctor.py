"""The port's ``doctor`` stage against tracs_tpu's on this machine: the
external-tool lines and the exit code equal the reference's (the cases of
tests/test_real_tools.py::test_doctor_reports_reality and
test_doctor_cli_exit_code), and ``check_runtime`` reports torch, the card,
nvcc and every kernel source where tracs_tpu reports JAX devices: without a
card or nvcc those are problem lines naming the card path they block, and
``--device cpu`` reports them without counting them."""

import argparse
import shutil

import pytest
import torch

from tracs_tpu_torch import cli as port_cli
from tracs_tpu_torch.runtime.build import KERNELS
from tracs_tpu_torch.stages import doctor as port

jax = pytest.importorskip("jax")

from tracs_tpu.stages import doctor as ref  # noqa: E402

_ALIGNER_TOOLS = ("minimap2", "samtools", "htsbox", "gzip")


def _run(module, capsys, argv=()):
    args = module.doctor_parser(argparse.ArgumentParser()).parse_args(list(argv))
    rc = module.doctor(args)
    return rc, capsys.readouterr().out.splitlines()


def _tool_lines(lines):
    tools = (*ref._TOOLS, *ref._OPTIONAL)
    return [ln for ln in lines if any(ln.split()[1:2] == [f"{t}:"] for t in tools)]


def _no_card_here():
    return not torch.cuda.is_available() and shutil.which("nvcc") is None


def test_doctor_reports_reality(capsys):
    """The tool lines equal tracs_tpu's; the exit code is non-zero iff a
    required tool or (with the default --device cuda) the card path is
    missing, and every missing tool has a FAIL line."""
    rc_ref, ref_lines = _run(ref, capsys)
    rc, lines = _run(port, capsys)
    assert _tool_lines(lines) == _tool_lines(ref_lines)
    assert len(_tool_lines(lines)) == len(ref._TOOLS) + len(ref._OPTIONAL)
    missing = [t for t in ("sourmash", *_ALIGNER_TOOLS) if not shutil.which(t)]
    for tool in missing:
        assert any(ln.startswith("FAIL") and tool in ln for ln in lines)
    runtime_missing = any(ln.startswith("FAIL") and ("card" in ln or "nvcc" in ln
                                                     or "kernel" in ln) for ln in lines)
    assert (rc != 0) == bool(missing or runtime_missing)
    assert ("All checks passed." in lines) == (rc == 0)
    if missing:
        assert rc_ref != 0 and rc != 0


def test_doctor_cli_exit_code():
    missing = [t for t in ("sourmash", *_ALIGNER_TOOLS) if not shutil.which(t)]
    if missing or _no_card_here():
        with pytest.raises(SystemExit) as exc:
            port_cli.main(["doctor"])
        assert exc.value.code == 1
    else:
        port_cli.main(["doctor"])  # must not raise


def test_check_runtime_without_card_or_nvcc_names_the_card_path():
    if not _no_card_here():
        pytest.skip("this machine has a card or nvcc")
    ok, problems = port.check_runtime("cuda")
    text = "\n".join(ok + problems)
    assert "jax" not in text.lower()
    assert any(ln.startswith("torch ") and torch.__version__ in ln for ln in ok)
    assert any(ln.startswith("native host library") for ln in ok)
    card = [ln for ln in problems if ln.startswith("card: none visible")]
    nvcc = [ln for ln in problems if ln.startswith("nvcc:")]
    kernels = [ln for ln in problems if ln.startswith("kernel ")]
    assert len(card) == 1 and len(nvcc) == 1
    assert [ln.split()[1] for ln in kernels] == [f"{k}.cu:" for k in KERNELS]
    assert all("blocks the card path" in ln for ln in card + nvcc + kernels)
    assert len(problems) == 2 + len(KERNELS)


def test_device_cpu_reports_the_card_without_counting_it(capsys):
    ok, problems = port.check_runtime("cpu")
    assert problems == []  # the native library builds here
    assert any(ln.startswith("card:") and "not needed with --device cpu" in ln for ln in ok)
    assert any(ln.startswith("nvcc:") and "not needed with --device cpu" in ln for ln in ok)
    assert not any(ln.startswith("kernel ") for ln in ok)
    rc, lines = _run(port, capsys, ["--device", "cpu"])
    missing = [t for t in ("sourmash", *_ALIGNER_TOOLS) if not shutil.which(t)]
    assert (rc != 0) == bool(missing)
    assert not any(ln.startswith("FAIL") and ("card" in ln or "nvcc" in ln) for ln in lines)


def test_micro_pipeline_reports_a_failing_aligner(monkeypatch):
    """The live probe turns an aligner failure into a problem line."""
    def broken(*args, **kwargs):
        raise RuntimeError("minimap2 refused the flags")

    monkeypatch.setattr("tracs_tpu_torch.io.external.align_and_pileup", broken)
    assert port.run_micro_pipeline() == ["pileup pipeline FAILED: minimap2 refused the flags"]
