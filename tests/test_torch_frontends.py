"""The port's front ends (``reze_tpu_torch.examples``) on the CPU: each
``main`` once on a written ``testing.make_pmx_spec(0, "small")`` scene at
64x64 (demo, crowd) or 128x64 (serve), with ``--device cpu``.

* demo: three frames; it writes three PNGs and a GIF; the first
  PNG decodes (``formats.image``) to the Engine's first frame exactly; the
  GIF parses: its logical screen is 64x64, it holds three frames, and the
  first decodes (LZW, checked here by a decoder of this file) to the
  palette indices of the first frame;
* crowd: three characters, a montage two wide, black beside the odd one,
  written as a PNG that decodes to it;
* serve: on a thread with ``--port 0``, each route once: the page, a
  frame that decodes to (64, 128, 3), the five stats keys, an orbit that
  changes the next frame (the clip is off, ``--no-anim``, so only the
  camera and the settling physics move it), and a 404;
* without a card, ``--device cuda`` (the default) raises.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from reze_tpu_torch import testing
from reze_tpu_torch.examples import crowd, demo, serve
from reze_tpu_torch.formats import image
from test_torch_frame import _one_thread  # noqa: F401

SIZE = 64
STATS_KEYS = {"fps", "frame_time", "gpu_memory", "pair_overflow", "contact_overflow"}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("frontends")
    pmx, vmd = testing.write_scene(str(d), testing.make_pmx_spec(0, "small"))
    return d, ["--model", pmx, "--motion", vmd, "--device", "cpu"]


def parse_gif(data: bytes):
    """-> (width, height, [each frame's (h, w) palette indices]): the
    logical screen, and each image's LZW stream decoded."""
    assert data[:6] == b"GIF89a" and data[-1:] == b"\x3b"
    w, h, packed = (int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little"),
                    data[10])
    i = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    frames = []
    while data[i] != 0x3B:
        if data[i] == 0x21:  # an extension: label, then sub-blocks
            i += 2
            while data[i]:
                i += data[i] + 1
            i += 1
            continue
        assert data[i] == 0x2C
        fw, fh = int.from_bytes(data[i + 5:i + 7], "little"), int.from_bytes(data[i + 7:i + 9],
                                                                             "little")
        min_size, i, stream = data[i + 10], i + 11, bytearray()
        while data[i]:
            stream += data[i + 1:i + 1 + data[i]]
            i += data[i] + 1
        i += 1
        frames.append(np.frombuffer(lzw_decode(bytes(stream), min_size), np.uint8)
                      .reshape(fh, fw))
    return w, h, frames


def lzw_decode(stream: bytes, min_size: int) -> bytes:
    bits = np.unpackbits(np.frombuffer(stream, np.uint8), bitorder="little")
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    pos, size, out, table, prev = 0, min_size + 1, bytearray(), [], None
    while True:
        code = int(bits[pos:pos + size] @ (1 << np.arange(size)))
        pos += size
        if code == clear:
            table = [bytes([c]) for c in range(clear)] + [b"", b""]
            size, prev = min_size + 1, None
            continue
        if code == eoi:
            return bytes(out)
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else table[prev] + table[prev][:1]
            if len(table) < 4096:
                table.append(table[prev] + entry[:1])
        out += entry
        prev = code
        if len(table) == 1 << size and size < 12:
            size += 1


def test_demo_writes_frames_and_gif(scene):
    d, args = scene
    r = demo.main(args + ["--frames", "3", "--size", str(SIZE), "--out", str(d / "demo")])
    assert len(r["pngs"]) == len(r["frames"]) == 3 and r["fps"] > 0
    first = image.load_image(r["pngs"][0])
    np.testing.assert_array_equal(first[..., :3], r["frames"][0])
    assert (first[..., 3] == 255).all() and r["frames"][0].max() > 0
    with open(r["gif"], "rb") as f:
        w, h, frames = parse_gif(f.read())
    assert (w, h, len(frames)) == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(frames[0], image.gif_indices(r["frames"][0]))


def test_crowd_writes_montage(scene):
    d, args = scene
    r = crowd.main(args + ["--batch", "3", "--size", str(SIZE), "--frames", "1", "--out",
                           str(d / "crowd")])
    assert r["frames"].shape == (3, SIZE, SIZE, 3) and r["char_frames_per_s"] > 0
    grid = image.load_image(r["png"])[..., :3]
    assert grid.shape == (2 * SIZE, 2 * SIZE, 3)
    np.testing.assert_array_equal(grid, r["montage"])
    np.testing.assert_array_equal(grid[SIZE:, :SIZE], r["frames"][2])
    assert grid[SIZE:, SIZE:].max() == 0  # black beside the odd one
    assert all(f.max() > 0 for f in r["frames"])


def test_serve_answers_every_route(scene):
    _, args = scene
    server = serve.main(args + ["--size", "128x64", "--port", "0", "--no-anim"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=120) as r:
            return r.headers["Content-Type"], r.read()

    try:
        kind, page = get("/")
        assert kind == "text/html" and b"<canvas" in page and b"width=128" in page
        kind, png = get("/frame")
        a = image.decode_image(png)[..., :3]
        assert kind == "image/png" and a.shape == (64, 128, 3) and a.max() > 0
        b = image.decode_image(get("/frame")[1])[..., :3]
        assert get("/input?orbit=300,0")[1] == b"ok"
        c = image.decode_image(get("/frame")[1])[..., :3]
        still, turned = (a != b).any(-1).mean(), (b != c).any(-1).mean()
        assert turned > 0.05 and turned > 5 * still, (still, turned)
        for q in ("pan=5,5", "zoom=20"):
            assert get(f"/input?{q}")[1] == b"ok"
        kind, body = get("/stats")
        stats = json.loads(body)
        assert kind == "application/json" and set(stats) == STATS_KEYS
        assert stats["pair_overflow"] == 0 and stats["frame_time"] > 0
        with pytest.raises(urllib.error.HTTPError, match="404"):
            get("/nothing")
    finally:
        server.shutdown()
        thread.join(30)
        server.server_close()
    assert not thread.is_alive()


@pytest.mark.parametrize("front_end", [demo, crowd, serve])
def test_front_ends_refuse_without_a_card(scene, front_end, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        front_end.main(scene[1][:4])
    with pytest.raises(SystemExit):  # no model and no --written-flagship
        front_end.main(["--device", "cpu"])
