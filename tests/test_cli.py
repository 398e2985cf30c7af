"""CLI end-to-end smoke tests (in-process main())."""

import os

import numpy as np
import pytest
from PIL import Image

from simple_raytracer.cli import main


def test_cli_render(tmp_path):
    out = str(tmp_path / "f.png")
    rc = main(["render", "--scene", "four_cubes", "--width", "80",
               "--height", "60", "--mode", "bvh", "--out", out])
    assert rc == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (60, 80, 3)
    bg = np.all(img == np.array([173, 216, 230]), axis=-1)
    assert 0.05 < (~bg).mean() < 0.95


def test_cli_animate_resume(tmp_path):
    out_dir = str(tmp_path / "gen")
    args = ["animate", "--scene", "one_cube", "--width", "48", "--height",
            "32", "--step-deg", "180", "--orbit-radius", "100",
            "--camera-y", "0", "--pitch-deg", "0", "--out-dir", out_dir]
    assert main(args) == 0
    files = sorted(os.listdir(out_dir))
    assert files == ["output0.bmp", "output180.bmp"]
    mtime = os.path.getmtime(os.path.join(out_dir, files[0]))
    assert main(args) == 0          # resume: untouched
    assert os.path.getmtime(os.path.join(out_dir, files[0])) == mtime


def test_cli_train_checkpoint(tmp_path):
    ck = str(tmp_path / "ck.npz")
    rc = main(["train", "--scene", "one_cube", "--width", "24", "--height",
               "16", "--steps", "4", "--no-shadows", "--checkpoint", ck,
               "--log-every", "2"])
    assert rc == 0
    assert os.path.exists(ck)
    rc = main(["train", "--scene", "one_cube", "--width", "24", "--height",
               "16", "--steps", "6", "--no-shadows", "--checkpoint", ck,
               "--log-every", "2"])
    assert rc == 0


def test_cli_default_mode_is_tiled(tmp_path, monkeypatch):
    """`python -m simple_raytracer render` with no mode flag takes the
    fast path of the platform: mode 'auto' is the Triton walk ('tiled')
    on a GPU and the jnp oracle on the CPU, where it still renders."""
    import argparse
    import jax
    from simple_raytracer import cli
    p = argparse.ArgumentParser()
    cli._add_render_flags(p)
    args = p.parse_args([])
    assert args.mode == "auto"
    assert cli._config_from(args).mode == "bruteforce"
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "gpu")
        assert cli._config_from(args).mode == "tiled"

    out = str(tmp_path / "g.png")
    rc = main(["render", "--scene", "four_cubes", "--width", "80",
               "--height", "60", "--out", out])
    assert rc == 0
    img = np.asarray(Image.open(out))
    bg = np.all(img == np.array([173, 216, 230]), axis=-1)
    assert 0.05 < (~bg).mean() < 0.95
