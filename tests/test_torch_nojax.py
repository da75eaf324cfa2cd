"""The port runs without JAX, refuses a CUDA device it does not have, and
refuses the processing flags whose slices are not ported yet."""

import os
import subprocess
import sys

import pytest
import torch

from mlvfs_tpu.format import synth
from mlvfs_tpu_torch import cli
from mlvfs_tpu_torch.pipeline import kernels
from mlvfs_tpu_torch.pipeline.config import ProcessingConfig
from mlvfs_tpu_torch.pipeline.convert import convert_clip

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax(tmp_path):
    """Importing the port and converting a clip on the CPU loads no jax."""
    code = (
        "import sys\n"
        "import mlvfs_tpu_torch, mlvfs_tpu_torch.cli, mlvfs_tpu_torch.pipeline.convert\n"
        "import mlvfs_tpu_torch.ops.unpack, mlvfs_tpu_torch.ops.pixels\n"
        "from mlvfs_tpu.format import synth\n"
        f"synth.write_mlv({str(tmp_path / 'C.MLV')!r}, width=64, height=16, frames=2, audio=True)\n"
        f"rc = mlvfs_tpu_torch.cli.main(['convert', {str(tmp_path / 'C.MLV')!r}, '-o', "
        f"{str(tmp_path / 'out')!r}, '--device', 'cpu', '--all'])\n"
        "assert rc == 0, rc\n"
        "print('jax' in sys.modules, sorted(m for m in sys.modules if m.startswith('jax')))\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "False []"
    assert len([n for n in os.listdir(tmp_path / "out") if n.endswith(".dng")]) == 2


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=16, frames=1)
    with pytest.raises(RuntimeError, match="is_available"):
        convert_clip(src, str(tmp_path / "out"), ProcessingConfig())
    assert not os.path.exists(tmp_path / "out" / "C_000000.dng")


@pytest.mark.parametrize("field, value", [
    ("deflicker", 3000), ("fix_pattern_noise", True), ("dual_iso", 1), ("dual_iso", 2),
    ("fix_bad_pixels", 1), ("chroma_smooth", 3), ("fix_stripes", True),
    ("stripes_batch_cal", True),
])
def test_unported_flag_raises(field, value, tmp_path):
    cfg = ProcessingConfig(device="cpu", **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        kernels.check_supported(cfg)
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=16, frames=1)
    with pytest.raises(NotImplementedError, match="not ported"):
        convert_clip(src, str(tmp_path / "out"), cfg)


@pytest.mark.parametrize("flags", [["--cs3x3"], ["--dual-iso", "--mean23"], ["--deflicker=3000"],
                                   ["--bad-pix"], ["--devices", "4"]])
def test_cli_unported_flag_fails_clearly(flags, tmp_path, capsys):
    src = str(tmp_path / "C.MLV")
    synth.write_mlv(src, width=64, height=16, frames=1)
    out = str(tmp_path / "out")
    assert cli.main(["convert", src, "-o", out, "--device", "cpu", *flags]) == 2
    err = capsys.readouterr().err
    assert "not ported" in err and flags[0].split("=")[0] in err
    assert not os.path.exists(out)
