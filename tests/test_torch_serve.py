"""The port's HTTP server (mies_tpu_torch/serve.py) on the CPU.

Every case of tests/test_serve.py against ``make_server(...,
device="cpu")``: the responses equal the port's ``enhance_image`` on the
same bytes and, within one level on fewer than 1e-3 of the pixels, the
reference's ``mies_tpu.serve``; the CLAHE stage's levels equal cv2's.
Each server binds 127.0.0.1:0, every request has a timeout, and every
server is shut down in a ``finally``.
"""

from __future__ import annotations

import io
import json
import socket
import sys
import threading
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from mies_tpu_torch import serve as S
from mies_tpu_torch.io.dicom import write_dicom
from mies_tpu_torch.pipeline import runner
from mies_tpu_torch.pipeline.config import PipelineConfig
from mies_tpu_torch.pipeline.export import export_pipeline, load_exported

TIMEOUT = 60
STAGES = [("clahe", {"clip_limit": 2.0, "grid_size": (4, 4)}),
          ("adjust_gamma", {"gamma": 0.9})]


def _cfg(stages=STAGES, name="serve-test") -> PipelineConfig:
    return PipelineConfig.make(stages, name=name)


@contextmanager
def _running(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(TIMEOUT)


@pytest.fixture(scope="module")
def server():
    with _running(S.make_server(_cfg(), port=0, device="cpu")) as url:
        yield url


def _png_bytes(rng, shape=(64, 64)) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _post(url, body, ctype="image/png"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST")
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _decode_png(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def _within_one_level(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (
        diff.max(), (diff > 0).mean())


def test_healthz_and_config(server):
    with urllib.request.urlopen(server + "/healthz", timeout=TIMEOUT) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["pipeline"] == "serve-test"
    assert h["backend"] == "cpu" and h["mode"] == "jit"
    with urllib.request.urlopen(server + "/config", timeout=TIMEOUT) as r:
        c = json.loads(r.read())
    assert c["pipeline"][0]["op"] == "clahe"
    assert c == json.loads(json.dumps(_cfg().to_dict()))


def test_enhance_png_roundtrip(server, tmp_path):
    """The response is the port's enhance_image of the same bytes, within
    one level of the reference's server, its CLAHE levels cv2's."""
    import cv2

    from mies_tpu.pipeline.config import PipelineConfig as JaxConfig
    from mies_tpu.serve import make_server as jax_server

    png = _png_bytes(np.random.default_rng(0))
    with _post(server + "/enhance", png) as r:
        assert r.headers["Content-Type"] == "image/png"
        out = _decode_png(r.read())
    assert out.shape == (64, 64) and out.dtype == np.uint8
    src = tmp_path / "in.png"
    src.write_bytes(png)
    np.testing.assert_array_equal(
        out, runner.enhance_image(src, _cfg(), device="cpu"))
    with _running(jax_server(JaxConfig.make(STAGES, name="serve-test"),
                             host="127.0.0.1", port=0)) as ref_url:
        with _post(ref_url + "/enhance", png) as r:
            ref = _decode_png(r.read())
    _within_one_level(out, ref)
    clahe_only = runner.enhance_image(src, _cfg(STAGES[:1]), device="cpu")
    np.testing.assert_array_equal(
        clahe_only, cv2.createCLAHE(2.0, (4, 4)).apply(_decode_png(png)))
    with urllib.request.urlopen(server + "/healthz", timeout=TIMEOUT) as r:
        assert [64, 64] in json.loads(r.read())["compiled_shapes"]


def test_enhance_metrics_header(server):
    with _post(server + "/enhance?metrics=psnr,ssim",
               _png_bytes(np.random.default_rng(1))) as r:
        m = json.loads(r.headers["X-Mies-Metrics"])
    assert set(m) == {"psnr", "ssim"} and np.isfinite(m["psnr"])


def test_enhance_dicom_by_filename(server, tmp_path):
    hu = np.random.default_rng(2).integers(-200, 1200, (32, 32)).astype(
        np.int16)
    p = tmp_path / "s.dcm"
    write_dicom(p, hu)
    with _post(server + "/enhance?filename=s.dcm", p.read_bytes(),
               ctype="application/octet-stream") as r:
        assert r.headers["Content-Type"] == "image/png"
        out = _decode_png(r.read())
    np.testing.assert_array_equal(out, runner.enhance_image(p, _cfg(),
                                                            device="cpu"))


def test_bad_requests_isolated(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/enhance", b"not an image")
    assert e.value.code == 400 and "error" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/enhance", b"")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope", timeout=TIMEOUT)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/other", b"x")
    assert e.value.code == 404
    with _post(server + "/enhance", _png_bytes(np.random.default_rng(3))) as r:
        assert r.status == 200


def test_concurrent_requests_are_all_recorded():
    """More client threads than cores and a short switch interval: every
    request answered and recorded once (the shared timings and shapes)."""
    srv = S.make_server(_cfg([("adjust_gamma", {"gamma": 0.9})], "stress"),
                        port=0, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _running(srv) as url:
            bodies = [_png_bytes(np.random.default_rng(i), (8 + i % 3, 16))
                      for i in range(3)]
            errors = []

            def client(k):
                try:
                    for j in range(6):
                        with _post(url + "/enhance", bodies[(k + j) % 3]) as r:
                            r.read()
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
            assert not any(t.is_alive() for t in threads) and not errors
            assert len(srv.state.timings) == 16 * 6
            assert srv.state.shapes == {(8, 16), (9, 16), (10, 16)}
    finally:
        sys.setswitchinterval(old)


def test_make_server_needs_the_card_by_default():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        S.make_server(_cfg(), port=0)


def test_serve_warms_the_chain_and_announces(monkeypatch, tmp_path, capsys):
    """``serve`` builds and warms the server's chain, then announces it
    (the blocking loop replaced by a stand-in that closes the server)."""
    cfgp = tmp_path / "c.json"
    cfgp.write_text(json.dumps(_cfg().to_dict()))
    seen = {}

    def run(srv, announce):
        seen["srv"] = srv
        print(json.dumps(announce))
        srv.server_close()

    monkeypatch.setattr(S, "_run_server", run)
    S.serve(cfgp, port=0, warmup=(32, 48), device="cpu")
    line = json.loads(capsys.readouterr().out)
    assert line["pipeline"] == "serve-test" and line["serving"].startswith(
        "http://127.0.0.1:")
    assert seen["srv"].state.chain is not None


# --- artifact mode ------------------------------------------------------------


class TestArtifactMode:
    @pytest.fixture(scope="class")
    def artifact(self, tmp_path_factory):
        cfg = _cfg([("adjust_gamma", {"gamma": 0.9}),
                    ("unsharp_mask", {"radius": 1.0, "amount": 0.5})],
                   "artifact-test")
        p = export_pipeline(cfg, tmp_path_factory.mktemp("a") / "c.mies",
                            shape=(64, 64), device="cpu")
        fn, hdr = load_exported(p, device="cpu")
        return cfg, fn, hdr

    @pytest.fixture(scope="class")
    def artifact_server(self, artifact):
        cfg, fn, hdr = artifact
        with _running(S.make_server(cfg, port=0, artifact_fn=fn,
                                    artifact_header=hdr,
                                    device="cpu")) as url:
            yield url

    def test_enhance_via_artifact(self, artifact, artifact_server):
        png = _png_bytes(np.random.default_rng(4))
        with _post(artifact_server + "/enhance", png) as r:
            assert r.status == 200
            out = _decode_png(r.read())
        assert out.shape == (64, 64) and out.dtype == np.uint8
        x = _decode_png(png).astype(np.float32) / 255.0
        np.testing.assert_array_equal(
            out, artifact[1](torch.from_numpy(x)).numpy())

    def test_healthz_reports_artifact_mode(self, artifact_server):
        with urllib.request.urlopen(artifact_server + "/healthz",
                                    timeout=TIMEOUT) as r:
            assert json.loads(r.read())["mode"] == "artifact"

    def test_shape_mismatch_is_400_with_guidance(self, artifact_server):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(artifact_server + "/enhance",
                  _png_bytes(np.random.default_rng(5), (32, 32)))
        assert ei.value.code == 400 and b"re-export" in ei.value.read()

    def test_metrics_rejected_in_artifact_mode(self, artifact_server):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(artifact_server + "/enhance?metrics=psnr",
                  _png_bytes(np.random.default_rng(6)))
        assert ei.value.code == 400

    def test_unservable_artifacts_rejected_at_startup(self, tmp_path):
        cfg = _cfg([("adjust_gamma", {"gamma": 0.9})], "bad")
        batched = export_pipeline(cfg, tmp_path / "b.mies", shape=(32, 32),
                                  batch_size=4, device="cpu")
        with pytest.raises(ValueError, match="--batch 1"):
            S.validate_servable_artifact(load_exported(batched,
                                                       device="cpu")[1])
        unq = export_pipeline(cfg, tmp_path / "u.mies", shape=(32, 32),
                              quantize=False, device="cpu")
        with pytest.raises(ValueError, match="quantize"):
            S.validate_servable_artifact(load_exported(unq, device="cpu")[1])
        with pytest.raises(ValueError, match="input_dtype"):
            S.validate_servable_artifact({"input_shape": [8, 8],
                                          "input_dtype": "int8"})

    def test_uint8_artifact_serves_raw_ingest(self, tmp_path):
        """A uint8-spec artifact receives the raw pixels and equals the
        float32-spec artifact on the normalized input, and the chain."""
        cfg = _cfg([("clahe", {"clip_limit": 2.0, "grid_size": (4, 4)})],
                   "u8art")
        fn, hdr = load_exported(export_pipeline(
            cfg, tmp_path / "u8.mies", shape=(64, 64), input_dtype="uint8",
            device="cpu"), device="cpu")
        assert hdr["input_dtype"] == "uint8"
        png = _png_bytes(np.random.default_rng(7))
        with _running(S.make_server(cfg, port=0, artifact_fn=fn,
                                    artifact_header=hdr,
                                    device="cpu")) as url:
            with _post(url + "/enhance", png) as r:
                out = _decode_png(r.read())
        ffn, _ = load_exported(export_pipeline(
            cfg, tmp_path / "f.mies", shape=(64, 64), device="cpu"),
            device="cpu")
        src = _decode_png(png)
        ref = ffn(torch.from_numpy(src.astype(np.float32) / 255.0)).numpy()
        np.testing.assert_array_equal(out, ref)
        src_path = tmp_path / "in.png"
        src_path.write_bytes(png)
        np.testing.assert_array_equal(
            out, runner.enhance_image(src_path, cfg, device="cpu"))

    def test_int16_ct_artifact_serves_dicom(self, tmp_path):
        cfg = _cfg([("window_hu", {"center": 40.0, "width": 400.0}),
                    ("adjust_gamma", {"gamma": 0.9})], "ct-art")
        fn, hdr = load_exported(export_pipeline(
            cfg, tmp_path / "ct.mies", shape=(64, 64), input_dtype="int16",
            device="cpu"), device="cpu")
        dcm = tmp_path / "s.dcm"
        write_dicom(dcm, np.random.default_rng(8).integers(
            -500, 1500, (64, 64)).astype(np.int16))
        with _running(S.make_server(cfg, port=0, artifact_fn=fn,
                                    artifact_header=hdr,
                                    device="cpu")) as url:
            with _post(url + "/enhance", dcm.read_bytes(),
                       ctype="application/dicom") as r:
                out = _decode_png(r.read())
        assert out.shape == (64, 64) and out.dtype == np.uint8 and out.std() > 0
        np.testing.assert_array_equal(
            out, runner.enhance_image(dcm, cfg, device="cpu"))


# --- the body cap -------------------------------------------------------------


class TestBodyCap:
    @pytest.fixture(scope="class")
    def small_server(self):
        srv = S.make_server(_cfg([("adjust_gamma", {"gamma": 0.9})],
                                 "cap-test"), port=0, max_body_bytes=4096,
                            device="cpu")
        with _running(srv):
            yield srv.server_address[1]

    def test_oversized_body_is_413(self, small_server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{small_server}/enhance",
                  _png_bytes(np.random.default_rng(9), (256, 256)))
        assert e.value.code == 413
        assert "max-body-mb" in json.loads(e.value.read())["error"]

    def test_huge_declared_length_rejected_without_body(self, small_server):
        with socket.create_connection(("127.0.0.1", small_server),
                                      timeout=TIMEOUT) as s:
            s.sendall(b"POST /enhance HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: image/png\r\n"
                      b"Content-Length: 1099511627776\r\n\r\n")
            resp = s.recv(4096).decode()
        assert resp.split()[1] == "413", resp[:80]

    def test_invalid_content_length_is_400(self, small_server):
        with socket.create_connection(("127.0.0.1", small_server),
                                      timeout=TIMEOUT) as s:
            s.sendall(b"POST /enhance HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: banana\r\n\r\n")
            resp = s.recv(4096).decode()
        assert resp.split()[1] == "400", resp[:80]

    def test_small_body_still_served(self, small_server):
        with _post(f"http://127.0.0.1:{small_server}/enhance",
                   _png_bytes(np.random.default_rng(10), (32, 32))) as r:
            assert r.status == 200
