"""The main path needs no package beyond JAX, numpy and the standard
library: the preset reader, the PNG codec and the compile-cache rule."""

import glob
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest

from parakeet_slam_tpu.core.config import parse_yaml
from parakeet_slam_tpu.data.png import read_gray, read_png, write_png
from parakeet_slam_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]
PRESETS = sorted(glob.glob(str(ROOT / "configs" / "*.yaml")))


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: Path(p).stem)
def test_yaml_reader_matches_pyyaml(preset):
    yaml = pytest.importorskip("yaml")
    text = Path(preset).read_text()
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: [1, 2\n", "a: 'open\n", "just words\n", "a:b\n",
])
def test_yaml_reader_rejects_malformed(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


@pytest.mark.parametrize("img", [
    np.arange(37 * 53, dtype=np.uint32).reshape(37, 53).astype(np.uint8),
    np.random.default_rng(0).integers(0, 256, (20, 31, 3), dtype=np.uint8),
    np.random.default_rng(1).integers(0, 65536, (9, 17), dtype=np.uint16),
], ids=["gray8", "rgb8", "gray16"])
def test_png_roundtrip(tmp_path, img):
    write_png(tmp_path / "x.png", img)
    out = read_png(tmp_path / "x.png")
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)


def _filtered_png(img: np.ndarray) -> bytes:
    """RGB8 PNG whose rows cycle through all five filter types."""
    h, w, _ = img.shape
    bpp, raw, prev = 3, b"", np.zeros(w * 3, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        left = np.r_[np.zeros(bpp, np.int32), cur[:-bpp]]
        up_left = np.r_[np.zeros(bpp, np.int32), prev[:-bpp]]
        f = y % 5
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data)
        )

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_reads_every_filter_type(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (10, 7, 3), dtype=np.uint8)
    (tmp_path / "f.png").write_bytes(_filtered_png(img))
    np.testing.assert_array_equal(read_png(tmp_path / "f.png"), img)
    gray = read_gray(tmp_path / "f.png")
    assert gray.shape == (10, 7) and 0.0 <= gray.min() and gray.max() <= 1.0


def test_main_path_runs_without_flax_yaml_cv2(tmp_path):
    """cli, system and every data loader import, and the corridor run
    (phase (a) of chip_smoke.py, shortened) completes, with flax, yaml and
    cv2 made unimportable."""
    script = (
        "import sys\n"
        "for name in ('flax', 'yaml', 'cv2'):\n"
        "    sys.modules[name] = None\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import parakeet_slam_tpu.system\n"
        "import parakeet_slam_tpu.data.tum, parakeet_slam_tpu.data.kitti\n"
        "import parakeet_slam_tpu.data.euroc, parakeet_slam_tpu.data.synth_vision\n"
        "import parakeet_slam_tpu.data.panoramic\n"
        "from parakeet_slam_tpu import cli\n"
        "r = cli.main(['run', '--config', 'configs/corridor.yaml',\n"
        "              '--set', 'data.num_steps=20'])\n"
        "assert r['frames'] == 20 and r['ate'] == r['ate'], r\n"
        "print('OK')\n"
    )
    env = {**os.environ, "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cache")}
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert Path(path) == ROOT / ".jax_cache"
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)

