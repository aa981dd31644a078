"""The port's HTTP endpoint (``runet_tpu_torch/infer/http_serve.py``): a real
``ThreadingHTTPServer`` on an ephemeral port over the oracle bundles on the
CPU, as ``tests/test_http_serve.py`` drives the JAX package's. The wire
path (NIfTI bytes in, gzipped labelmap and JSON report out) must equal the
in-process ``predict_case`` / ``predict_volume``, and the report the JAX
package's ``InferenceService`` on the same volume but for ``latency_s``."""

import gzip
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from runet_tpu.config import CascadeConfig as JCascade
from runet_tpu.infer.http_serve import InferenceService as JService
from runet_tpu.io.nifti import volume_from_bytes as j_volume_from_bytes
from runet_tpu_torch.config import CascadeConfig
from runet_tpu_torch.eval.surface import volumetry
from runet_tpu_torch.infer import http_serve
from runet_tpu_torch.infer.cascade import predict_case, predict_volume
from runet_tpu_torch.infer.http_serve import InferenceService, make_server
from runet_tpu_torch.io.nifti import volume_from_bytes, volume_to_bytes
from tests.test_torch_cascade import CASCADE, SPACING, _bundles, _label_image


def _serve(service):
    srv = make_server(service, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address[:2]
    return srv, t, f"http://{host}:{port}"


@pytest.fixture(scope="module")
def server():
    _, _, coarse, fine = _bundles()
    cascade = CascadeConfig(**CASCADE)
    srv, t, base = _serve(InferenceService(fine, coarse, cascade, device="cpu"))
    yield base, coarse, fine, cascade
    srv.shutdown()
    t.join(timeout=5)


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _post_error(url, body) -> tuple[int, dict]:
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, body)
    return ei.value.code, json.loads(ei.value.read())


def test_healthz(server):
    base, *_ = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        h = json.loads(resp.read())
    assert h == {"status": "ok", "device": "cpu", "cascade": True, "num_classes": 3}


def test_predict_matches_in_process(server):
    base, coarse, fine, cascade = server
    img, _ = _label_image()
    status, headers, payload = _post(base + "/v1/predict",
                                     volume_to_bytes(img, spacing=SPACING, gz=True))
    assert status == 200
    assert headers["Content-Type"] == "application/gzip"
    got = volume_from_bytes(payload)
    want = predict_case(coarse, fine, img, SPACING, cascade, device="cpu")
    np.testing.assert_array_equal(got.data, want)
    assert got.spacing == SPACING
    report = json.loads(headers["X-Runet-Report"])
    assert report["shape"] == list(img.shape)
    assert report["spacing_mm"] == list(SPACING)
    assert {k: report[k] for k in ("volume_ml_c1", "volume_ml_c2")} == volumetry(want, SPACING, 3)
    assert report["volume_ml_c1"] > 0 and report["latency_s"] >= 0


def test_report_only(server):
    base, *_ = server
    img, _ = _label_image()
    # A plain (not gzipped) NIfTI body is accepted too: the magic is sniffed.
    status, headers, payload = _post(base + "/v1/report",
                                     volume_to_bytes(img, spacing=SPACING, gz=False))
    assert status == 200
    assert headers["Content-Type"] == "application/json"
    report = json.loads(payload)
    assert "volume_ml_c2" in report and "latency_s" in report


def test_bad_body_is_400_and_survivable(server):
    base, coarse, fine, cascade = server
    code, err = _post_error(base + "/v1/predict", b"this is not a nifti volume")
    assert code == 400 and "unparseable" in err["error"]
    # A truncated gzip sniffs as gzip and fails inside decompress: 400 too.
    code, _ = _post_error(base + "/v1/report", gzip.compress(b"x" * 64)[:20])
    assert code == 400
    img, _ = _label_image()
    status, _, payload = _post(base + "/v1/predict", volume_to_bytes(img, spacing=SPACING))
    assert status == 200
    want = predict_case(coarse, fine, img, SPACING, cascade, device="cpu")
    np.testing.assert_array_equal(volume_from_bytes(payload).data, want)


def test_unknown_route_404(server):
    base, *_ = server
    assert _post_error(base + "/v1/nope", b"x")[0] == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert ei.value.code == 404


def test_length_limits_and_prediction_failure(server, monkeypatch):
    """411 without a body, 413 past ``MAX_BODY_BYTES``, 500 when the model
    raises; the server keeps serving after each."""
    base, *_ = server
    assert _post_error(base + "/v1/predict", b"")[0] == 411
    img, _ = _label_image()
    body = volume_to_bytes(img, spacing=SPACING)
    monkeypatch.setattr(http_serve, "MAX_BODY_BYTES", len(body) - 1)
    code, err = _post_error(base + "/v1/report", body)
    assert code == 413 and str(len(body)) in err["error"]
    monkeypatch.undo()

    _, _, coarse, fine = _bundles()

    def broken(_p, w):
        raise RuntimeError("model fault")

    bad = InferenceService(fine.__class__(broken, None, 3, fine.preprocess, fine.infer), coarse,
                           CascadeConfig(**CASCADE), device="cpu")
    srv, t, bad_base = _serve(bad)
    try:
        code, err = _post_error(bad_base + "/v1/predict", body)
        assert code == 500 and "model fault" in err["error"]
    finally:
        srv.shutdown()
        t.join(timeout=5)
    assert _post(base + "/v1/report", body)[0] == 200


def test_plain_fine_only_service():
    """No coarse model: /v1/predict routes through ``predict_volume``."""
    _, _, _, fine = _bundles()
    service = InferenceService(fine, device="cpu")
    assert service.health()["cascade"] is False
    srv, t, base = _serve(service)
    try:
        img, _ = _label_image()
        status, headers, payload = _post(base + "/v1/predict",
                                         volume_to_bytes(img, spacing=SPACING))
        assert status == 200
        assert json.loads(headers["X-Runet-Report"])["shape"] == list(img.shape)
        want = predict_volume(fine, img, SPACING, device="cpu")
        np.testing.assert_array_equal(volume_from_bytes(payload).data, want)
    finally:
        srv.shutdown()
        t.join(timeout=5)


@pytest.mark.parametrize("with_coarse", [True, False], ids=["cascade", "fine-only"])
def test_report_equals_jax_service(with_coarse):
    """The same body through both packages' services: labels equal, reports
    equal but for ``latency_s``."""
    jcoarse, jfine, tcoarse, tfine = _bundles()
    img, _ = _label_image()
    body = volume_to_bytes(img.astype(np.int16), spacing=SPACING)
    jsvc = JService(jfine, jcoarse if with_coarse else None, JCascade(**CASCADE))
    tsvc = InferenceService(tfine, tcoarse if with_coarse else None, CascadeConfig(**CASCADE),
                            device="cpu")
    jpred, jrep = jsvc.predict(j_volume_from_bytes(body))
    tpred, trep = tsvc.predict(volume_from_bytes(body))
    np.testing.assert_array_equal(tpred, jpred)
    assert trep.pop("latency_s") >= 0 and jrep.pop("latency_s") >= 0
    assert trep == jrep


def test_service_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    _, _, coarse, fine = _bundles()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceService(fine, coarse)


@pytest.mark.parametrize("tier", ["native", "fallback"])
def test_chip_smoke_serve_http_phase_gates(tier, monkeypatch):
    """``chip_smoke.py``'s serve_http phase on the CPU with small U-Nets and
    a small phantom: every request, status and comparison passes, and the
    phase then fails on its launch gates, since a CPU tensor launches no
    kernel; with the native loader at None it fails first on the native
    gate (a run that fell back to scipy fails)."""
    import chip_smoke

    from runet_tpu_torch.utils import native
    from tests.test_torch_cascade import _small_unet_bundles

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "cpu")
    monkeypatch.setattr(chip_smoke, "QUALITY_SHAPE", (64, 64, 40))
    if tier == "fallback":
        monkeypatch.setattr(native, "_load", lambda: None)
    coarse, fine = _small_unet_bundles()
    match = ("was not launched" if tier == "native"
             else r"native host tier was not used .*label_components_3d")
    with pytest.raises(AssertionError, match=match):
        chip_smoke.phase_serve_http(torch.device("cpu"), coarse, fine, CascadeConfig(**CASCADE))
