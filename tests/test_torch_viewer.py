"""The port's viewer (``fractal_tpu_torch.viewer``) against the JAX
package's (``fractal_tpu/viewer.py``), on the CPU: the scene's JSON, the
exact pan, the first frame, latest-wins coalescing (gui.rs:37-48), the
reset that keeps the canvas (gui.rs:334-339), /nav and /pos, the status
headers, the 2x screenshot (gui.rs:319-328) and frames across a mesh.

One server, bound to port 0 (the JAX viewer's tests bind 8791 and 8792),
renders on the CPU; every test that posts a config waits for that config's
own frame, so no render is in flight when the next test starts, and the
fixture drains the worker before ``shutdown()``.
"""

import io
import json
import sys
import threading
import time
import types
import urllib.error
import urllib.request as rq
from fractions import Fraction

import numpy as np
import pytest
from PIL import Image

from fractal_tpu import viewer as jax_viewer
from fractal_tpu.cli import parse_options as jax_parse
from fractal_tpu.config import Scene as JaxScene
from fractal_tpu.config import scene_defaults as jax_defaults
from fractal_tpu.render import render as jax_render
from fractal_tpu_torch import RGB, Scene, render, viewer
from fractal_tpu_torch.cli import parse_options
from fractal_tpu_torch.config import exact_pos
from fractal_tpu_torch.ops import _cuda_build, native_walk

FLAGS = ["64", "48", "--format", "png"]


def _get(base, path):
    r = rq.urlopen(base + path, timeout=60)
    return r.headers, r.read()


def _post(base, path, obj):
    req = rq.Request(base + path, json.dumps(obj).encode(), method="POST")
    return json.loads(rq.urlopen(req, timeout=60).read() or b"{}")


def _decode(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def _gen(base) -> int:
    return int(_get(base, "/image")[0]["X-Gen"])


def _wait_frame(base, g0, want, timeout=60.0):
    """The first frame after generation ``g0`` for which ``want(headers,
    image)`` holds; fails at ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        h, png = _get(base, "/image")
        if int(h["X-Gen"]) > g0 and png[:4] == b"\x89PNG" and want(h, _decode(png)):
            return h, _decode(png)
        time.sleep(0.05)
    pytest.fail(f"no such frame after generation {g0} within {timeout} s")


def _render(scene: Scene) -> np.ndarray:
    """``render(scene, "cpu")`` under the viewer's lock: the render path's
    module state is the worker's too."""
    with viewer._RENDER_LOCK:
        return render(scene, "cpu")


def _still_of(scene: Scene):
    img = _render(scene)
    return lambda h, got: got.shape == img.shape and np.array_equal(got, img)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    shot = tmp_path_factory.mktemp("viewer") / "shot"
    opts = parse_options(FLAGS + ["-o", str(shot)])
    srv = viewer.start(opts, port=0, open_browser=False, block=False, device="cpu")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    _wait_frame(base, 0, lambda h, img: True)
    yield types.SimpleNamespace(base=base, opts=opts, shot=str(shot))
    # drain: no new generation for a second (a render in flight at
    # interpreter exit can crash it)
    g, quiet = _gen(base), time.monotonic()
    while time.monotonic() - quiet < 1.0:
        time.sleep(0.1)
        if _gen(base) != g:
            g, quiet = _gen(base), time.monotonic()
    srv.shutdown()
    srv.server_close()


def test_scene_json_roundtrip_and_dict_match_jax():
    kw = dict(algo="julia", width=64, height=48, julia_set=(-0.8, 0.156),
              pos_str=("0.25", "-0.125"), scale=(3.0, 3.0), precision="p32", power=3)
    s = Scene(**kw, primary_color=RGB(1, 2, 3))
    d = viewer.scene_to_dict(s)
    assert viewer.scene_from_dict(json.loads(json.dumps(d))) == s
    from fractal_tpu.config import RGB as JaxRGB

    assert d == jax_viewer.scene_to_dict(JaxScene(**kw, primary_color=JaxRGB(1, 2, 3)))
    # a browser-side pan moves the f64 pos off the exact string: it is dropped
    moved = dict(d, pos=[d["pos"][0] + 0.5, d["pos"][1]])
    assert viewer.scene_from_dict(moved).pos_str is None
    assert jax_viewer.scene_from_dict(moved).pos_str is None


def test_apply_nav_exact_pan_past_f64_matches_jax():
    """At 1e26x a 40-pixel pan is ~2.5e-26, far below the f64 spacing at
    |x| ~ 2, yet the exact centre moves by it, the port's ``pos_str`` is the
    JAX viewer's, and the render sees the move (tests/test_viewer.py:90-119)."""
    kw = dict(width=24, height=16, iterations=300,
              pos_str=("-1.999999999999999999999999999", "0.0000000000000000000000000035"),
              scale=(1e26, 1e26))
    scene = Scene(**kw)
    moved = viewer.apply_nav(scene, pan=(40.0 / 16.0, 0.0))
    want = jax_viewer.apply_nav(JaxScene(**kw), pan=(40.0 / 16.0, 0.0))
    assert moved.pos_str == want.pos_str
    (e0, _), (e1, _) = exact_pos(scene), exact_pos(moved)
    assert e1 - e0 == Fraction(40, 16) / Fraction(1e26)
    assert float(e1) == float(e0)
    assert (_render(scene) != _render(moved)).any()
    z = viewer.apply_nav(scene, zoom=2.0)
    assert z.scale == (2e26, 2e26) and z.pos_str == scene.pos_str


def test_first_frame_equals_the_jax_viewers(server):
    """The first frame at 64x48 decodes to the JAX viewer's frame of the same
    CLI flags (its ``_render_frame`` output through its ``_encode_png``)
    but on a few chaotic boundary pixels, and to the port's still exactly;
    the headers name the f32 tier.  The JAX frame is f32 jitted on XLA:CPU,
    which contracts a*b + c into FMAs, and torch's eager ops never fuse:
    measured 3 of 3,072 pixels, at (20, 52), (24, 14) and (28, 52); held to
    0.5 % of the image."""
    h, png = _get(server.base, "/image?gen=0")
    assert png[:4] == b"\x89PNG" and int(h["X-Gen"]) >= 1
    assert h["X-Tier"] == "f32" and h["X-Glitch"] == "" and float(h["X-Device-Ms"]) >= 0
    scene = viewer.scene_from_dict(json.loads(_get(server.base, "/scene")[1]))
    assert scene == server.opts.scene
    jax_scene = jax_parse(FLAGS).scene
    want = _decode(jax_viewer._encode_png(np.asarray(jax_render(jax_scene))))
    got = _decode(png)
    assert got.shape == want.shape == (48, 64, 3)
    assert int((got != want).any(-1).sum()) <= 0.005 * 48 * 64
    np.testing.assert_array_equal(got, _render(scene))


def test_coalescing_latest_wins(server):
    """15 rapid posts while a render runs give 1-5 renders, the last of
    them the last config's (one in-flight render, latest wins)."""
    base = server.base
    scene = json.loads(_get(base, "/scene")[1])
    scene.update(width=320, height=240, iterations=500)
    g0 = _gen(base)
    _post(base, "/config", scene)
    h, _ = _wait_frame(base, g0, _still_of(viewer.scene_from_dict(scene)))
    render_ms = float(h["X-Device-Ms"])
    g0 = int(h["X-Gen"])
    t0 = time.perf_counter()
    for i in range(15):
        scene["exposure"] = 5.0 + 0.5 * (i + 1)
        _post(base, "/config", scene)
    burst_ms = (time.perf_counter() - t0) * 1e3
    h, _ = _wait_frame(base, g0, _still_of(viewer.scene_from_dict(scene)), timeout=90.0)
    n = int(h["X-Gen"]) - g0
    assert burst_ms < render_ms, (burst_ms, render_ms)  # the burst needs coalescing
    assert 1 <= n <= 5, n
    scene.update(width=64, height=48, iterations=50, exposure=5.0)
    g0 = int(h["X-Gen"])
    _post(base, "/config", scene)
    _wait_frame(base, g0, _still_of(viewer.scene_from_dict(scene)))


def test_reset_keeps_the_canvas(server):
    base = server.base
    before = json.loads(_get(base, "/scene")[1])
    d = _post(base, "/reset", {"algo": "fern"})
    assert d["algo"] == "fern" and d["iterations"] == 10_000_000
    assert (d["width"], d["height"]) == (before["width"], before["height"])
    assert d["secondary_color"] == [240, 240, 240]
    g0 = _gen(base)
    d = _post(base, "/reset", {"algo": "mandelbrot"})
    _wait_frame(base, g0, _still_of(viewer.scene_from_dict(d)))
    assert d == json.loads(json.dumps(jax_viewer.scene_to_dict(
        jax_defaults("mandelbrot").replace(width=before["width"], height=before["height"]))))


def test_nav_endpoint(server):
    base = server.base
    x0 = exact_pos(viewer.scene_from_dict(json.loads(_get(base, "/scene")[1])))[0]
    out = _post(base, "/nav", {"pan": [0.25, 0.0]})
    assert Fraction(out["pos_str"][0]) == x0 + Fraction(0.25) / Fraction(out["scale"][0])
    out2 = _post(base, "/nav", {"zoom": 2.0})
    assert out2["scale"][0] == 2 * out["scale"][0]
    g0 = _gen(base)
    out3 = _post(base, "/nav", {"pan": [-0.25, 0.0], "zoom": 0.5})
    _wait_frame(base, g0, _still_of(viewer.scene_from_dict(out3)))


def test_pos_exact_at_depth_and_400_on_a_bad_string(server):
    """A typed 1e20x centre round-trips exactly (the strings become
    ``pos_str``); a string that is not a number is a 400 and leaves the
    scene as it was."""
    base = server.base
    x = "-0.743643887037158704752191506114774"
    y = "0.131825904205311970493132056385139"
    out = _post(base, "/pos", {"x": x, "y": y, "scale": 1e20})
    assert out["pos_str"] == [x, y] and out["scale"] == [1e20, 1e20]
    assert json.loads(_get(base, "/scene")[1])["pos_str"] == [x, y]
    out2 = _post(base, "/pos", {"scale": 0.4})
    assert out2["scale"] == [0.4, 0.4] and out2["pos_str"] == [x, y]
    out3 = _post(base, "/pos", {"julia": [-0.8, 0.156]})
    assert out3["julia_set"] == [-0.8, 0.156]
    req = rq.Request(base + "/pos", json.dumps({"x": "not-a-number", "y": "0"}).encode(),
                     method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        rq.urlopen(req, timeout=30)
    assert e.value.code == 400
    assert json.loads(_get(base, "/scene")[1])["pos_str"] == [x, y]
    g0 = _gen(base)
    out4 = _post(base, "/pos", {"x": "-0.6", "y": "0.0", "scale": 0.4})
    _wait_frame(base, g0, _still_of(viewer.scene_from_dict(out4)))


def test_status_headers_tier_route_and_glitch(server):
    """At 1e15x the frame's headers name the perturb tier, the CPU's δ-orbit
    route for a quadratic view (f32 BLA) and a glitch count; at the default
    view the f32 tier with an empty glitch field."""
    base = server.base
    scene = json.loads(_get(base, "/scene")[1])
    scene.update(width=48, height=32, iterations=200, precision="auto",
                 pos=[-0.74364388703715871, 0.13182590420531198], pos_str=None,
                 scale=[1e15, 1e15])
    g0 = _gen(base)
    _post(base, "/config", scene)
    h, img = _wait_frame(base, g0, _still_of(viewer.scene_from_dict(scene)))
    assert h["X-Tier"] == "perturb" and h["X-Route"] == "f32 BLA"
    assert h["X-Glitch"].isdigit() and h["X-Residual"] == "0"
    assert float(h["X-Device-Ms"]) > 0
    g1 = int(h["X-Gen"])
    scene.update(scale=[0.4, 0.4], pos=[-0.6, 0.0], iterations=50)
    _post(base, "/config", scene)
    h, _ = _wait_frame(base, g1, _still_of(viewer.scene_from_dict(scene)))
    assert h["X-Tier"] == "f32" and h["X-Glitch"] == "" and h["X-Route"] == ""


def test_screenshot_is_the_2x_still(server):
    base = server.base
    scene = viewer.scene_from_dict(json.loads(_get(base, "/scene")[1]))
    want = _render(scene.replace(width=scene.width * 2, height=scene.height * 2))
    path = server.shot + ".png"
    _post(base, "/screenshot", {})
    deadline, got = time.monotonic() + 60, None
    while time.monotonic() < deadline:
        try:
            got = np.asarray(Image.open(path).convert("RGB"))
            break
        except (OSError, SyntaxError):  # not written yet, or half written
            time.sleep(0.1)
    assert got is not None and got.shape == (scene.height * 2, scene.width * 2, 3)
    np.testing.assert_array_equal(got, want)


def test_a_mesh_is_refused_naming_item_7():
    """The mesh is ported: ``RenderWorker(mesh=)`` renders each frame across
    it, the frame of one device, with its shard count in the status; only a
    mesh past the device count is refused, as the reference refuses it."""
    from fractal_tpu_torch.parallel.sharding import Mesh

    mesh = Mesh(("cpu",) * 3)
    worker = viewer.RenderWorker(mesh=mesh, device="cpu")
    for sc in (Scene(width=40, height=27, iterations=60),
               Scene(width=32, height=24, iterations=100, precision="p32",
                     pos=(-0.74364388703715871, 0.13182590420531198), scale=(1e15, 1e15))):
        g0 = worker.snapshot()[0]
        worker.request(sc)
        g, png, _, stats = worker.wait_for(g0, timeout=60)
        assert g > g0 and stats["devices"] == 3
        np.testing.assert_array_equal(_decode(png), _render(sc))
    assert not viewer._mesh_route(Scene(precision="f64"), mesh, "cpu")
    opts = parse_options(FLAGS)
    with pytest.raises(ValueError, match="only 8 device"):
        viewer.start(types.SimpleNamespace(**{**vars(opts), "devices": 9}), port=0,
                     open_browser=False, block=False, device="cpu")


@pytest.mark.parametrize("module,load", [(_cuda_build, "load"), (native_walk, "_load")],
                         ids=["kernels", "orbit walker"])
def test_a_cold_load_from_many_threads_builds_once(module, load, monkeypatch):
    """Eight threads (more than the cores here) load the library at once
    with a short switch interval: the slow build runs once and every thread
    gets the one library."""
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return "lib.so"

    class Lib:  # accepts the signatures load() sets
        def __getattr__(self, name):
            if name.endswith("abi_version"):
                return lambda: native_walk.ABI_VERSION
            return types.SimpleNamespace(argtypes=None, restype=None)

    monkeypatch.setattr(module, "_LIB", None)
    monkeypatch.setattr(module, "build", slow_build)
    monkeypatch.setattr(module.ctypes, "CDLL", lambda path: Lib())
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(getattr(module, load)()))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(builds) == 1 and len(got) == 8
    assert all(lib is got[0] for lib in got)
