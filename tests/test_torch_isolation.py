"""The port stands alone: it imports neither JAX nor the JAX package, and
its default (CUDA) entry points raise where there is no card."""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from h264_fer_tpu_torch import entry
from h264_fer_tpu_torch.codec.decoder import Decoder
from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder, GopIpppEncoder
from h264_fer_tpu_torch.parallel.tile import GopTileIntraEncoder, TileIntraEncoder

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "h264_fer_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the subprocesses' torch on one thread, as this process's: tensors of a few
# MBs run no faster on more, and the test workers share the cores
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "h264_fer_tpu")


def test_entry_on_cpu_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import h264_fer_tpu_torch as port\n"
        "fn, args = port.entry(device='cpu')\n"
        "words, nbits, recon = fn(*args)\n"
        "assert int(nbits) > 0 and tuple(recon.shape) == (144, 176)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'h264_fer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_session_encoder_and_cli_leave_jax_out_of_sys_modules(tmp_path, fixtures_dir):
    """The session Encoder, its host per-MB path (the CLI's default encode)
    and the CLI (encode, psnr) run on the CPU without importing JAX or the
    JAX package."""
    src, dst = fixtures_dir / "clip_qcif_10f.y4m", tmp_path / "out.264"
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from h264_fer_tpu_torch.cli import main\n"
        "from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig\n"
        "from h264_fer_tpu_torch.codec.encoder_host import HostEncoder\n"
        f"assert main(['encode', {str(src)!r}, {str(dst)!r}, '--end-frame', '2',"
        " '--deblock', '--device', 'cpu']) == 0\n"
        f"assert main(['psnr', {str(src)!r}, {str(src)!r}]) == 0\n"
        "enc = Encoder(32, 32, EncoderConfig(deblock=True), device='cpu')\n"
        "z = np.zeros((32, 32), np.uint8)\n"
        "assert enc.encode_sequence([(z, z[::2, ::2], z[::2, ::2])] * 2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'h264_fer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"


def test_decoder_and_cli_decode_leave_jax_out_of_sys_modules(tmp_path, fixtures_dir):
    """The Decoder in both forms, with the filter (plain K8 on the CPU), and
    the CLI's decode run without importing JAX or the JAX package."""
    src = fixtures_dir / "ref_qcif_ippp_qp28.264"
    session = tmp_path / "session.264"
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from h264_fer_tpu_torch.cli import main\n"
        "from h264_fer_tpu_torch.codec.decoder import Decoder\n"
        "from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig\n"
        "enc = Encoder(32, 32, EncoderConfig(deblock=True), device='cpu')\n"
        "z = np.full((32, 32), 90, np.uint8)\n"
        f"open({str(session)!r}, 'wb').write(enc.encode_sequence([(z, z[::2, ::2], z[::2, ::2])] * 2))\n"
        "for native in (True, False):\n"
        f"    frames = list(Decoder(True, device='cpu', native=native).decode_annexb(open({str(session)!r}, 'rb').read()))\n"
        "    assert len(frames) == 2 and frames[1][0].shape == (32, 32)\n"
        f"assert main(['decode', {str(src)!r}, {str(tmp_path / 'out.y4m')!r}, '--deblock',"
        " '--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'h264_fer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"


def test_multi_device_encoders_leave_jax_out_of_sys_modules():
    """The band encoders (both intra modes and IPPP), the GOP-parallel
    encoders over a device list, the multi-process spans and the dry run
    run on the CPU without importing JAX or the JAX package."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from h264_fer_tpu_torch.parallel import dist, dryrun\n"
        "from h264_fer_tpu_torch.parallel.gop_device import GopIpppEncoder, scaling_frames\n"
        "from h264_fer_tpu_torch.parallel.tile import GopTileIntraEncoder, TileIntraEncoder\n"
        "from h264_fer_tpu_torch.parallel.tile_p import TileIpppEncoder\n"
        "frames = scaling_frames(32, 48, 2)\n"
        "a = TileIntraEncoder(32, 48, 28, devices=['cpu'] * 2).encode_sequence(frames)\n"
        "b = GopTileIntraEncoder(32, 48, 28, 2, 2, devices=['cpu'] * 4,"
        " mode='mixed').encode_sequence(frames)\n"
        "c = GopIpppEncoder(32, 48, 28, gop_len=2, devices=['cpu'] * 2).encode_sequence(frames)\n"
        "d = TileIpppEncoder(32, 48, 28, gop_len=2, devices=['cpu'] * 3).encode_sequence(frames)\n"
        "assert a and b and c and d == c\n"
        "assert dist.encode_multihost(frames, 32, 48, 28, devices=['cpu'])\n"
        "dryrun.dryrun_multichip(['cpu'] * 2, log=lambda line: None)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'h264_fer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"


KERNEL_MODULES = ("wavefront_i16", "me_int", "me_qpel", "wavefront_p", "mc", "wavefront_i4x4",
                  "wavefront_mixed", "deblock", "me_topk", "cavlc_slice", "mode_decision",
                  "residual_p", "interp")


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_kernel_module_imports_without_a_build(module):
    """Each kernel wrapper module (K10: cavlc_slice, its source
    csrc/cavlc_slice.cu; K11: mode_decision, csrc/mode_decision.cu; K12:
    residual_p, csrc/residual_p.cu; K13: interp, csrc/interp.cu) imports
    on a machine without nvcc and builds nothing until a launch;
    chip_smoke.py builds every source."""
    import chip_smoke
    from h264_fer_tpu_torch.kernels import build

    importlib.import_module(f"h264_fer_tpu_torch.kernels.{module}")
    assert module not in build._libs
    assert (build.CSRC / f"{module}.cu").exists()
    assert sorted(chip_smoke.KERNEL_SOURCES) == sorted(KERNEL_MODULES)
    assert sorted(f.stem for f in build.CSRC.glob("*.cu")) == sorted(KERNEL_MODULES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        GopIntraEncoder(176, 144, 28)
    with pytest.raises(RuntimeError, match="CUDA"):
        GopIntraEncoder(176, 144, 28, mode="mixed")
    with pytest.raises(RuntimeError, match="CUDA"):
        GopIpppEncoder(176, 144, 28, gop_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        GopIntraEncoder(176, 144, 28, devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TileIntraEncoder(176, 144, 28)
    with pytest.raises(RuntimeError, match="CUDA"):
        GopTileIntraEncoder(176, 144, 28, 2, 2, mode="mixed")
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(176, 144, EncoderConfig(deblock=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(176, 144, EncoderConfig(), iframe="mixed")
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(176, 144, EncoderConfig(deblock=True), iframe="host", pframe="host",
                device_modes=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder(deblock=True, native=False)
