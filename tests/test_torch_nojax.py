"""The port runs without JAX and without the reference package, refuses a CUDA
device it does not have, converts with the processing flags its slices have
ported (held against mlvfs_tpu), and refuses the flag whose slice is not
ported yet (multi-GPU batches)."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from mlvfs_tpu.pipeline.config import ProcessingConfig as RefConfig
from mlvfs_tpu.pipeline.convert import convert_clip as ref_convert
from mlvfs_tpu_torch import cli
from mlvfs_tpu_torch.format import synth
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
from mlvfs_tpu_torch.pipeline.convert import convert_clip

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(outdir):
    return {n: (outdir / n).read_bytes() for n in sorted(os.listdir(outdir))}


def test_port_imports_no_jax(tmp_path):
    """Importing the port and converting a clip with the ported flags on the
    CPU (pattern noise and the dual-ISO preview among them), and a dual-ISO
    clip with ``--dual-iso --mean23`` and with ``--dual-iso`` (amaze-edge, in
    the split and the mega AMaZE mode), loads neither jax nor any module of
    mlvfs_tpu, and opens no file under mlvfs_tpu/: the EOS M clip's bundled
    focus-pixel map and the LJ92 codec (--compress-dng) come from the port's
    own copies."""
    code = (
        "import builtins, ctypes, sys\n"
        "opened = []\n"
        "_open, _cdll = builtins.open, ctypes.CDLL.__init__\n"
        "def spy_open(f, *a, **k):\n"
        "    opened.append(str(f))\n"
        "    return _open(f, *a, **k)\n"
        "def spy_cdll(self, name, *a, **k):\n"
        "    opened.append(str(name))\n"
        "    return _cdll(self, name, *a, **k)\n"
        "builtins.open, ctypes.CDLL.__init__ = spy_open, spy_cdll\n"
        "import mlvfs_tpu_torch, mlvfs_tpu_torch.cli, mlvfs_tpu_torch.pipeline.convert\n"
        "import mlvfs_tpu_torch.ops.unpack, mlvfs_tpu_torch.ops.pixels\n"
        "import mlvfs_tpu_torch.ops.chroma_smooth, mlvfs_tpu_torch.ops.stripes\n"
        "import mlvfs_tpu_torch.ops.patternnoise_fused, mlvfs_tpu_torch.ops.dualiso\n"
        "import mlvfs_tpu_torch.ops.dualiso_full, mlvfs_tpu_torch.ops.alias\n"
        "import mlvfs_tpu_torch.ops.amaze, mlvfs_tpu_torch.ops.amaze_core\n"
        "import mlvfs_tpu_torch.ops.amaze_scans, mlvfs_tpu_torch.ops.amaze_edge\n"
        "import mlvfs_tpu_torch.ops.dualiso_preview_dev, mlvfs_tpu_torch.ops.evarith\n"
        "from mlvfs_tpu_torch.format import synth\n"
        f"synth.write_mlv({str(tmp_path / 'C.MLV')!r}, width=1808, height=727, frames=2,\n"
        "                camera_model=0x80000331, camera_name='Canon EOS M', audio=True)\n"
        f"rc = mlvfs_tpu_torch.cli.main(['convert', {str(tmp_path / 'C.MLV')!r}, '-o', "
        f"{str(tmp_path / 'out')!r}, '--device', 'cpu', '--cs3x3', '--stripes', "
        "'--deflicker', '3000', '--bad-pix', '--fix-pattern-noise', '--dual-iso-preview', "
        "'--compress-dng', '--all'])\n"
        "assert rc == 0, rc\n"
        f"synth.write_mlv({str(tmp_path / 'D.MLV')!r}, width=256, height=192, frames=2, dual_iso=3)\n"
        f"rc = mlvfs_tpu_torch.cli.main(['convert', {str(tmp_path / 'D.MLV')!r}, '-o', "
        f"{str(tmp_path / 'out_di')!r}, '--device', 'cpu', '--dual-iso', '--mean23', '--cs2x2', "
        "'--bad-pix'])\n"
        "assert rc == 0, rc\n"
        f"rc = mlvfs_tpu_torch.cli.main(['convert', {str(tmp_path / 'D.MLV')!r}, '-o', "
        f"{str(tmp_path / 'out_amaze')!r}, '--device', 'cpu', '--dual-iso'])\n"
        "assert rc == 0, rc\n"
        "import os\n"
        "os.environ['MLVFS_AMAZE_PALLAS_MODE'] = 'mega'\n"
        f"rc = mlvfs_tpu_torch.cli.main(['convert', {str(tmp_path / 'D.MLV')!r}, '-o', "
        f"{str(tmp_path / 'out_mega')!r}, '--device', 'cpu', '--dual-iso'])\n"
        "assert rc == 0, rc\n"
        "from mlvfs_tpu_torch.ops import alias, amaze_core, amaze_edge, amaze_scans, dualiso_recon\n"
        "assert alias.KERNEL_LAUNCHES == 0 and dualiso_recon.ALIAS_MAP_MAX == 15000\n"
        "assert dualiso_recon.KERNEL_LAUNCHES == 0\n"
        "assert amaze_core.KERNEL_LAUNCHES == amaze_edge.KERNEL_LAUNCHES == 0\n"
        "assert amaze_core.MEGA_LAUNCHES == 0 and amaze_core.pallas_mode() == 'mega'\n"
        "assert amaze_scans.KERNEL_LAUNCHES == amaze_scans.FRAME_LAUNCHES == 0\n"
        "print(sorted(m for m in sys.modules if m.startswith('jax')),\n"
        "      sorted(m for m in sys.modules if m == 'mlvfs_tpu' or m.startswith('mlvfs_tpu.')))\n"
        "print('\\n'.join(opened))\n"
    )
    # one torch thread: the test run's other workers hold the cores, and an
    # oversubscribed OpenMP pool makes each op of the conversions ~100x slower
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    modules = lines.index("[] []")  # no jax, no mlvfs_tpu
    opened = [os.path.realpath(p) for p in lines[modules + 1:]]
    port, ref = (os.path.join(os.path.realpath(_REPO), d) + os.sep
                 for d in ("mlvfs_tpu_torch", "mlvfs_tpu"))
    assert os.path.join(port, "data", "80000331_1808x727.fpm") in opened
    assert os.path.join(port, "build", "liblj92.so") in opened
    assert not [p for p in opened if p.startswith(ref)]
    assert len([n for n in os.listdir(tmp_path / "out") if n.endswith(".dng")]) == 2
    assert len([n for n in os.listdir(tmp_path / "out_di") if n.endswith(".dng")]) == 2
    assert len([n for n in os.listdir(tmp_path / "out_amaze") if n.endswith(".dng")]) == 2
    assert _tree(tmp_path / "out_mega") == _tree(tmp_path / "out_amaze")  # the CPU runs the twin in either mode


def _imports_reference(source: str) -> list:
    """Import statements of ``source`` that name mlvfs_tpu or a submodule of it."""
    found = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        found += [n for n in names if n == "mlvfs_tpu" or n.startswith("mlvfs_tpu.")]
    return found


def test_port_sources_never_import_the_reference():
    """No module of mlvfs_tpu_torch and no line of chip_smoke.py imports
    mlvfs_tpu (the subprocess above shows what a run loads and opens)."""
    pkg = os.path.join(_REPO, "mlvfs_tpu_torch")
    sources = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) >= 20
    for path in sources:
        with open(path, encoding="utf-8") as f:
            assert _imports_reference(f.read()) == [], path
    assert _imports_reference("import mlvfs_tpu.ops\nfrom mlvfs_tpu import cli\n") == [
        "mlvfs_tpu.ops", "mlvfs_tpu"]
    assert _imports_reference("import mlvfs_tpu_torch\nfrom . import mlvfs_tpu\n") == []


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=16, frames=1)
    with pytest.raises(RuntimeError, match="is_available"):
        convert_clip(src, str(tmp_path / "out"), ProcessingConfig())
    assert not os.path.exists(tmp_path / "out" / "C_000000.dng")


@pytest.mark.parametrize("field, value", [
    ("deflicker", 3000), ("fix_bad_pixels", 1), ("chroma_smooth", 3), ("fix_stripes", True),
    ("fix_pattern_noise", True), ("dual_iso", 1), ("dual_iso", 2), ("stripes_batch_cal", True),
])
def test_ported_flag_matches_jax(field, value, tmp_path):
    """The processing flags ported so far convert on the CPU, byte-identical
    to mlvfs_tpu (this clip is not dual-ISO: the preview and the full
    reconstruction pass it through). The whole-batch stripe calibration
    runs with the stripe fix it calibrates."""
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=16, frames=3)
    # no sidecars: each package calibrates the clip itself
    kw = dict(batch_size=2, use_sidecar_idx=False, **{field: value})
    if field == "stripes_batch_cal":
        kw["fix_stripes"] = True
    ref_convert(src, str(tmp_path / "ref"), RefConfig(**kw))
    convert_clip(src, str(tmp_path / "port"), ProcessingConfig(device="cpu", **kw))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")


@pytest.mark.parametrize("flags", [["--devices", "4"]])
def test_cli_unported_flag_fails_clearly(flags, tmp_path, capsys):
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=16, frames=1)
    out = str(tmp_path / "out")
    assert cli.main(["convert", src, "-o", out, "--device", "cpu", *flags]) == 2
    err = capsys.readouterr().err
    assert "not ported" in err and flags[0].split("=")[0] in err
    assert not os.path.exists(out)


@pytest.mark.parametrize("flags", [["--cs3x3"], ["--deflicker=3000"], ["--bad-pix"],
                                   ["--fix-pattern-noise"], ["--dual-iso-preview"],
                                   ["--dual-iso", "--mean23", "--cs3x3"], ["--dual-iso"],
                                   ["--stripes", "--stripes-batch-cal"]])
def test_cli_ported_flag_matches_jax(flags, tmp_path):
    from mlvfs_tpu import cli as ref_cli

    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=16, frames=3)
    flags = [*flags, "--no-idx"]  # no sidecars: each package calibrates the clip itself
    assert ref_cli.main(["convert", src, "-o", str(tmp_path / "ref"), *flags]) == 0
    assert cli.main(["convert", src, "-o", str(tmp_path / "port"), "--device", "cpu", *flags]) == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")


def test_device_fit_and_batch_calibration_import_no_jax(tmp_path):
    """``--dual-iso-preview`` with ``MLVFS_TPU_PREVIEW_DEV=1`` (the device
    fit, its plain twin on the CPU) and ``--stripes --stripes-batch-cal``
    convert with neither jax nor any module of mlvfs_tpu loaded."""
    code = (
        "import sys\n"
        "import mlvfs_tpu_torch.cli\n"
        "from mlvfs_tpu_torch.format import synth\n"
        "from mlvfs_tpu_torch.ops import dualiso_preview_dev, stripes\n"
        "calls = []\n"
        "for mod, name in ((dualiso_preview_dev, 'fit_sorted_plain'), (stripes, 'calibrate_batch_device')):\n"
        "    fn = getattr(mod, name)\n"
        "    setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))\n"
        f"synth.write_mlv({str(tmp_path / 'D.MLV')!r}, width=640, height=192, frames=2, dual_iso=3)\n"
        f"rc = mlvfs_tpu_torch.cli.main(['convert', {str(tmp_path / 'D.MLV')!r}, '-o', "
        f"{str(tmp_path / 'out')!r}, '--device', 'cpu', '--dual-iso-preview', '--stripes', "
        "'--stripes-batch-cal', '--no-idx'])\n"
        "assert rc == 0, rc\n"
        "assert sorted(calls) == ['calibrate_batch_device', 'fit_sorted_plain'], calls\n"
        "assert dualiso_preview_dev.KERNEL_LAUNCHES == 0\n"
        "print(sorted(m for m in sys.modules if m.startswith('jax')),\n"
        "      sorted(m for m in sys.modules if m == 'mlvfs_tpu' or m.startswith('mlvfs_tpu.')))\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1", MLVFS_TPU_PREVIEW_DEV="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[] []"
    assert len([n for n in os.listdir(tmp_path / "out") if n.endswith(".dng")]) == 2
