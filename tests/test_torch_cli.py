"""The port's CLI (``python -m fractal_tpu_torch``) against the JAX CLI:
same parse, same pixels (``--backend`` too), clean errors; the
``--animate`` frames and the ``--bands`` image against the port's API;
``--devices`` across the CPU's 8 shards; ``-g`` reaching the viewer and
``--trace`` writing a trace."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from fractal_tpu.cli import parse_options as jax_parse
from fractal_tpu_torch.__main__ import main
from fractal_tpu_torch.cli import parse_options

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def test_cli_png_matches_jax_cli(tmp_path):
    env = dict(os.environ, FRACTAL_TPU_PLATFORM="cpu")
    for pkg in ("fractal_tpu", "fractal_tpu_torch"):
        out = subprocess.run(
            [sys.executable, "-m", pkg, "75", "50", "--format", "png",
             "-o", str(tmp_path / pkg)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert f'Writing file "{tmp_path / pkg}.png"' in out.stdout
    port, ref = _png(tmp_path / "fractal_tpu_torch.png"), _png(tmp_path / "fractal_tpu.png")
    assert port.shape == (50, 75, 3)
    np.testing.assert_array_equal(port, ref)


ARGVS = [
    [],
    "-d 300 200".split(),
    "-a julia --julia-real -0.8 --julia-imaginary 0.156 -i 2000 -s 0.6 -e 30 200 100".split(),
    "-s 500000 -x -.7436447860 -y .1318252536 -i 4000 -d -e 5 400 200".split(),
    "--primary-color 102030 --secondary-color #ff0080 -u --stable-limit 4 16 8".split(),
    "-a multibrot --power 5 --supersample 2 --precision f32 --format png --seed 3".split(),
    "--scale-x 2 -l 100 -o out --open --precision p32".split(),
    "-a julia --julia-real -0.8 --julia-imaginary 0.156 --animate 8 64 48".split(),
    "--animate 4 --sweep zoom --zoom-from 2 --exact-sweep -s 1e12 32 24".split(),
    "--bands 16 --checkpoint-dir ck 64 48".split(),
    "-g 64 48".split(),
    "--trace tr --backend pallas --precision f64".split(),
    "--backend jnp --devices 1".split(),
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "defaults" for a in ARGVS])
def test_parse_matches_jax_cli(argv):
    want, got = jax_parse(argv), parse_options(argv)
    assert dataclasses.asdict(got.scene) == dataclasses.asdict(want.scene)
    fields = ("filename", "open", "gui", "fmt", "profile", "backend", "trace", "bands",
              "ckpt_dir", "animate", "sweep", "zoom_from", "exact_sweep", "devices")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]


ERRORS = [
    ("-a julia", "requires --julia-real"),
    ("-s 2 --scale-x 3", "--scale cannot be used"),
    ("--animate 4", "--sweep julia requires -a julia"),
    ("-a fern --bands 8 -o never", "banded rendering applies to escape-time scenes"),
    ("--devices 9", "--devices 9: only 8 device(s) available"),
    ("-g --devices 9", "--devices 9: only 8 device(s) available"),
    ("--devices -1", "--devices must be >= 0 (0 = all available)"),
    ("16 12 -s 1e35 -a burningship --precision perturb -o never", "1e30"),
    ("16 12 --precision p32 -a julia --power 1 --julia-real -0.8 "
     "--julia-imaginary 0.156 -o never", "perturbation supports"),
]


@pytest.mark.parametrize("args,message", ERRORS, ids=[e[0] for e in ERRORS])
def test_cli_errors_exit_cleanly(args, message, monkeypatch, tmp_path):
    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(args.split())
    assert message in str(e.value)
    assert not list(tmp_path.iterdir())


def test_cuda_platform_without_cuda_fails_cleanly(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for value in (None, "cuda", "gpu"):
        if value is None:
            monkeypatch.delenv("FRACTAL_TPU_PLATFORM", raising=False)
        else:
            monkeypatch.setenv("FRACTAL_TPU_PLATFORM", value)
        with pytest.raises(SystemExit) as e:
            main(["8", "8", "-o", str(tmp_path / "x")])
        assert "no CUDA device" in str(e.value)
    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="use cpu or cuda"):
        main(["8", "8", "-o", str(tmp_path / "x")])


def test_deep_profile_prints_tier_route_and_glitches(monkeypatch, tmp_path, capsys):
    """--profile of an exact deep render names the tier, the δ-orbit route
    (the f32 BLA route, the CPU's for a quadratic view), the glitch pixels
    and no unresolved residual (fractal_tpu/__main__.py: 113-130)."""
    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    rc = main("24 16 -x -2 -y 0 -s 1e16 -i 300 --precision perturb --format png "
              f"--profile -o {tmp_path / 'deep'}".split())
    assert rc == 0 and _png(tmp_path / "deep.png").shape == (16, 24, 3)
    out = capsys.readouterr().out
    assert "tier: perturb" in out and "kernel route: f32 BLA" in out
    assert "glitch pixels:" in out and "UNRESOLVED" not in out


def test_fern_cli_matches_jax_cli_and_profile_names_the_tier(monkeypatch, tmp_path, capsys):
    """``-a fern`` writes the JAX CLI's image for the same flags (seed,
    replicas, colours); ``--true-colors`` changes it (the fern is the one
    algorithm whose stored colour order shows); ``--profile`` names the
    tier and the histogram's route."""
    from fractal_tpu.__main__ import main as jax_main

    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    flags = "60 40 -a fern -i 60000 --seed 5 --fern-replicas 2 --primary-color 102030 " \
            "--format png"
    images = {}
    for name, run, extra in (("port", main, ""), ("jax", jax_main, ""),
                             ("port-true", main, " --true-colors"),
                             ("jax-true", jax_main, " --true-colors")):
        assert run(f"{flags}{extra} --profile -o {tmp_path / name}".split()) == 0
        images[name] = _png(tmp_path / f"{name}.png")
        out = capsys.readouterr().out
        if run is main:
            assert "tier: fern" in out and "histogram route: plain" in out
            assert "points: 60000 in 2 histogram call(s)" in out
    assert images["port"].shape == (40, 60, 3)
    np.testing.assert_array_equal(images["port"], images["jax"])
    np.testing.assert_array_equal(images["port-true"], images["jax-true"])
    assert (images["port"] != images["port-true"]).any()


def test_main_writes_png_with_profile(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    rc = main(["32", "24", "-i", "20", "--format", "png", "--profile",
               "-o", str(tmp_path / "img")])
    assert rc == 0
    assert _png(tmp_path / "img.png").shape == (24, 32, 3)
    out = capsys.readouterr().out
    assert "render (device)" in out and "encode+write" in out


def test_animate_writes_the_sweep_frames(monkeypatch, tmp_path, capsys):
    """``--animate 3 -a julia`` writes OUTPUT_0000.png ... OUTPUT_0002.png,
    each frame of ``render_sweep`` over the julia c-path (the JAX CLI's
    names, fractal_tpu/__main__.py:139-182)."""
    from fractal_tpu_torch import Scene
    from fractal_tpu_torch.animate import julia_c_path, render_sweep

    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    rc = main(f"48 32 -a julia --julia-real -0.8 --julia-imaginary 0.156 -i 60 -e 30 "
              f"--animate 3 --format png -o {tmp_path / 'anim'}".split())
    assert rc == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"anim_000{i}.png" for i in range(3)]
    cs = julia_c_path(np.linspace(0.0, 1.0, 3, endpoint=False))
    frames = render_sweep([Scene(algo="julia", width=48, height=32, iterations=60,
                                 exposure=30.0, pos_str=("0", "0"),
                                 julia_set=(float(a), float(b))) for a, b in cs],
                          device="cpu")
    for i in range(3):
        np.testing.assert_array_equal(_png(tmp_path / f"anim_000{i}.png"), frames[i])
    assert "wrote 3 frames" in capsys.readouterr().out


def test_bands_with_checkpoint_write_the_one_shot_image(monkeypatch, tmp_path, capsys):
    """``--bands 16 --checkpoint-dir`` writes the one-shot render's image,
    leaves a checkpoint of 3 bands, and ``--profile`` reports each band."""
    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    flags = "40 48 -s 2e4 -x -1.62 -y -0.01 -i 200 --precision ds32 --format png"
    assert main(f"{flags} -o {tmp_path / 'one'}".split()) == 0
    ck = tmp_path / "ck"
    assert main(f"{flags} --bands 16 --checkpoint-dir {ck} --profile "
                f"-o {tmp_path / 'banded'}".split()) == 0
    out = capsys.readouterr().out
    assert "band 3/3 (16 rows)" in out and "render (banded)" in out
    np.testing.assert_array_equal(_png(tmp_path / "banded.png"), _png(tmp_path / "one.png"))
    assert sorted(p.name for p in ck.iterdir()) == ["band_0.npy", "band_1.npy", "band_2.npy",
                                                   "manifest.json"]


def test_exact_zoom_animation_matches_jax_cli(monkeypatch, tmp_path):
    """``--animate 3 --sweep zoom --exact-sweep`` writes the JAX CLI's
    files, each frame within the exact tier's stated tolerance of the JAX
    CLI's: measured 4, 5 and 0 of 1,536 pixels at 1e3, 3.2e9 and 1e16
    (every frame flags pixels and is its still; the f32 δ-orbits of the
    glitch form are contracted in the jitted reference)."""
    from fractal_tpu.__main__ import main as jax_main

    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    flags = "48 32 -x -2 -y 0 -s 1e16 -i 300 --animate 3 --sweep zoom --zoom-from 1e3 " \
            "--exact-sweep --format png"
    for name, run in (("port", main), ("jax", jax_main)):
        (tmp_path / name).mkdir()
        assert run(f"{flags} -o {tmp_path / name / 'z'}".split()) == 0
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == \
        ["z_0000.png", "z_0001.png", "z_0002.png"]
    for n in names:
        port, ref = _png(tmp_path / "port" / n), _png(tmp_path / "jax" / n)
        assert port.shape == (32, 48, 3)
        assert int((port != ref).any(-1).sum()) <= 0.01 * 32 * 48


def test_gui_starts_the_viewer_before_any_render(monkeypatch, tmp_path):
    """``-g`` hands the parsed options and the platform's device to
    ``viewer.start`` (fractal_tpu/__main__.py:47-52), renders nothing itself
    and returns 0."""
    from fractal_tpu_torch import viewer

    calls = []
    monkeypatch.setattr(viewer, "start", lambda options, **kw: calls.append((options, kw)))
    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    assert main("-g 64 48 -i 80".split()) == 0
    [(options, kw)] = calls
    assert options.gui and kw == {"device": "cpu"}
    assert (options.scene.width, options.scene.height, options.scene.iterations) == (64, 48, 80)
    assert not list(tmp_path.iterdir())


def test_trace_writes_a_profiler_trace(monkeypatch, tmp_path, capsys):
    """``--trace DIR`` on the CPU writes a ``*.pt.trace.json`` into DIR that
    holds the render's events, and says so."""
    import json

    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    trace = tmp_path / "tr"
    assert main(f"32 24 -i 20 --trace {trace} --format png -o {tmp_path / 'img'}".split()) == 0
    [path] = trace.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert f"trace written to {trace}" in capsys.readouterr().out
    assert _png(tmp_path / "img.png").shape == (24, 32, 3)


BACKEND_FLAGS = "64 48 -i 100 --format png"


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_backend_png_matches_jax_cli(backend, monkeypatch, tmp_path):
    """``--backend jnp`` (the pixel-grid loop) and ``--backend pallas``
    (kernel A's f32 form; on the CPU its plain version, in the JAX package
    the Pallas interpreter) at f32 write the JAX CLI's image but for a few
    chaotic boundary pixels: XLA:CPU contracts a*b + c into FMAs inside jit,
    torch's eager ops never fuse.  Measured at this view: 3 (jnp) and 11
    (pallas) of 3,072 pixels; held to 1 %."""
    from fractal_tpu.__main__ import main as jax_main

    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    images = {}
    for name, run in (("port", main), ("jax", jax_main)):
        assert run(f"{BACKEND_FLAGS} --precision f32 --backend {backend} "
                   f"-o {tmp_path / name}".split()) == 0
        images[name] = _png(tmp_path / f"{name}.png")
    assert images["port"].shape == images["jax"].shape == (48, 64, 3)
    assert int((images["port"] != images["jax"]).any(-1).sum()) <= 0.01 * 48 * 64


def test_backend_pallas_at_f64_renders_the_f32_kernel(monkeypatch, tmp_path):
    """The JAX package's pallas route reads any precision but ds32 and dd64
    as one f32 word (escape_pallas.py:325-330), so ``--backend pallas
    --precision f64`` writes the f32 pallas image on both CLIs, and not the
    f64 one."""
    from fractal_tpu.__main__ import main as jax_main

    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    for name, run in (("port", main), ("jax", jax_main)):
        for extra in ("--precision f64 --backend pallas", "--precision f32 --backend pallas",
                      "--precision f64"):
            tag = extra.replace(" ", "").replace("--", "_")
            assert run(f"{BACKEND_FLAGS} {extra} -o {tmp_path / (name + tag)}".split()) == 0
        f64_pallas, f32_pallas, f64 = (
            _png(tmp_path / f"{name}{tag}.png")
            for tag in ("_precisionf64_backendpallas", "_precisionf32_backendpallas",
                        "_precisionf64"))
        np.testing.assert_array_equal(f64_pallas, f32_pallas)
        assert (f64_pallas != f64).any()


def test_devices_png_equals_one_device(monkeypatch, tmp_path, capsys):
    """``--devices 0`` (the CPU's 8 shards) and ``--devices 3`` write the
    ``--devices 1`` PNG: a still, a fern, bands and a sweep's frames."""
    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    runs = {"still": "75 51 -s 3e5 -x -.7436447860 -y .1318252536 -i 300 --precision ds32",
            "fern": "48 48 -a fern -i 30000 --seed 3",
            "bands": "64 37 --bands 16 --precision ds32",
            "sweep": "32 24 -a julia --julia-real -0.8 --julia-imaginary 0.156 --animate 3"}
    for name, flags in runs.items():
        images = {}
        for n in ("1", "0", "3"):
            out = tmp_path / f"{name}{n}"
            assert main(f"{flags} --devices {n} --format png --profile -o {out}".split()) == 0
            first = f"{out}_0002.png" if name == "sweep" else f"{out}.png"
            images[n] = _png(first)
            log = capsys.readouterr().out
            if n != "1" and name in ("still", "fern"):
                assert f"render ({8 if n == '0' else 3}-device mesh)" in log
        np.testing.assert_array_equal(images["0"], images["1"], err_msg=name)
        np.testing.assert_array_equal(images["3"], images["1"], err_msg=name)
