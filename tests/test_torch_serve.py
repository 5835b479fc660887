"""The port's serving stack (``depthg_tpu_torch/serve.py``) on the CPU with a
tiny ViT: the counterparts of ``tests/test_serve.py`` (coalescing, a full
batch dispatching at once, per-request errors, ``bucket_set``, quantiles,
HTTP routes and formats, ``build_service`` from a ``.ckpt`` the port
exported), what the port refuses (``max_batch`` not a multiple of
``n_devices``, a directory that is not an orbax checkpoint, an orbax
directory without tensorstore), replicas on two devices (every response
that of the single-device service, buckets of multiples of 2), the
serving contract (a served row equals the predict step on
the same padded batch; pad rows do not leak into other rows), and parity:
the same PNG bytes through the JAX ``SegmentationService`` and the port's,
from carried weights in float32: labels equal without the CRF, and on
>= 99.5% of pixels with it."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from depthg_tpu import inference as jinf
from depthg_tpu import serve as jserve
from depthg_tpu.models import featurizer as jfeat
from depthg_tpu.models import probes as jprobes
from depthg_tpu.models import vit as jvit
from depthg_tpu.ops import crf as jcrf
from depthg_tpu_torch import inference as tinf
from depthg_tpu_torch import serve as tserve
from depthg_tpu_torch import serve_loadgen
from depthg_tpu_torch.config import load_config
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.ops import crf as tcrf
from depthg_tpu_torch.serve import (BatcherMetrics, DynamicBatcher,
                                    SegmentationService, serve_http)
from depthg_tpu_torch.utils.ckpt import export_lightning_ckpt, state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)


def _tiny_model(seed=0):
    fcfg = tfeat.FeaturizerConfig(dim=16, vit_config=tvit.ViTConfig(**TINY))
    return tinf.Segmenter(fcfg, 5, 5).init_weights(torch.Generator().manual_seed(seed))


def _tiny_service(run_crf=False, max_batch=8, max_wait_ms=150.0, res=32):
    ecfg = tinf.EvalConfig(n_classes=5, run_crf=run_crf, label_res=res)
    return SegmentationService(_tiny_model(), ecfg, res=res, max_batch=max_batch,
                               max_wait_ms=max_wait_ms, device="cpu")


def _png_image(seed=0, size=48):
    from PIL import Image

    return Image.open(io.BytesIO(_png_bytes(seed, size))).convert("RGB")


def _png_bytes(seed=0, size=48):
    from PIL import Image

    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def _smooth_png_bytes(seed, size=80):
    """A few flat regions plus noise: labels away from ties, as a photo."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    low = rng.integers(0, 255, size=(5, 5, 3)).astype(np.float32)
    arr = np.kron(low, np.ones((size // 5, size // 5, 1), np.float32))
    arr = np.clip(arr + rng.normal(0, 6, arr.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def test_dynamic_batcher_coalesces_concurrent_submits():
    calls = []

    def run_batch(items):
        calls.append(len(items))
        return [x * 2 for x in items]

    b = DynamicBatcher(run_batch, max_batch=8, max_wait_ms=200.0)
    try:
        results = [None] * 6
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, b.submit(i))) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert results == [i * 2 for i in range(6)]
        snap = b.metrics.snapshot()
        assert snap["requests"] == 6 and snap["errors"] == 0
        # six requests inside one 200ms window must not run as six batches
        assert snap["batches"] < 6 and sum(calls) == 6
    finally:
        b.close()


def test_dynamic_batcher_full_batch_dispatches_immediately():
    seen = threading.Event()

    def run_batch(items):
        seen.set()
        return items

    b = DynamicBatcher(run_batch, max_batch=1, max_wait_ms=60_000.0)
    try:
        t0 = time.monotonic()
        assert b.submit("x", timeout=10) == "x"
        assert time.monotonic() - t0 < 5  # never waited the 60s window
        assert seen.is_set()
    finally:
        b.close()


def test_dynamic_batcher_propagates_errors_per_request():
    def run_batch(items):
        raise ValueError("boom")

    b = DynamicBatcher(run_batch, max_batch=4, max_wait_ms=5.0)
    try:
        with pytest.raises(ValueError, match="boom"):
            b.submit(1)
        # the dispatcher survives a failing batch
        b._run_batch = lambda items: items
        assert b.submit(7) == 7
        assert b.metrics.snapshot()["errors"] == 1
    finally:
        b.close()


def test_closed_batcher_refuses_submits():
    b = DynamicBatcher(lambda items: items, max_batch=2, max_wait_ms=1.0)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(1)
    with pytest.raises(ValueError, match="max_batch"):
        DynamicBatcher(lambda items: items, max_batch=0)


@pytest.mark.parametrize("max_batch,min_bucket", [(16, 1), (12, 1), (12, 6), (18, 6), (8, 8)])
def test_bucket_set_matches_dispatchable_buckets(max_batch, min_bucket):
    """warmup()'s enumeration equals the set _run_batch can emit, including
    a max_batch that is no power of two, as in the JAX package."""
    reachable = {tserve._bucket(n, max_batch, min_bucket) for n in range(1, max_batch + 1)}
    assert reachable == set(tserve.bucket_set(max_batch, min_bucket))
    assert all(b % min_bucket == 0 for b in reachable)
    assert tserve.bucket_set(max_batch, min_bucket) == jserve.bucket_set(max_batch, min_bucket)
    for n in range(1, max_batch + 1):
        assert tserve._bucket(n, max_batch, min_bucket) == jserve._bucket(n, max_batch, min_bucket)


def test_metrics_quantiles_empty_and_filled():
    m = BatcherMetrics()
    assert m.snapshot()["latency_ms_p50"] is None
    for v in (1.0, 2.0, 3.0, 4.0):
        m.record_request(v, ok=True)
    snap = m.snapshot()
    assert snap["latency_ms_p50"] == 3.0 and snap["latency_ms_p99"] == 4.0
    ref = jserve.BatcherMetrics()
    for v in (1.0, 2.0, 3.0, 4.0):
        ref.record_request(v, ok=True)
    for met in (m, ref):
        met.record_batch(3, 4)
        met.record_request(9.0, ok=False)
    assert m.snapshot() == ref.snapshot()  # same keys, same values


def test_service_matches_standalone_predict():
    svc = _tiny_service()
    try:
        body = _png_bytes(1)
        linear, cluster = svc.segment_bytes(body)
        assert linear.shape == (32, 32) and cluster.shape == (32, 32)
        assert linear.dtype == np.int32
        # same bytes again -> identical maps (pure function of the input)
        l2, c2 = svc.segment_bytes(body)
        np.testing.assert_array_equal(linear, l2)
        np.testing.assert_array_equal(cluster, c2)
        assert 0 <= int(cluster.min()) and int(cluster.max()) < 5
        assert svc.warmup() == [1, 2, 4, 8]
        assert svc.batcher.metrics.snapshot()["batches"] == 2  # warmup is not traffic
    finally:
        svc.close()


@pytest.mark.parametrize("run_crf", [False, True])
def test_served_rows_equal_the_predict_step_on_the_padded_batch(run_crf):
    """Three distinct images in one dispatch ride a bucket of 4 whose pad
    row is a copy of row 0: each result is its own image's row of
    ``make_predict_step`` on that padded batch, exactly. Posted
    concurrently, each response is its own image's (pad rows and
    neighbours do not leak)."""
    from PIL import Image

    svc = _tiny_service(run_crf=run_crf, max_batch=4, max_wait_ms=2000.0, res=64)
    try:
        bodies = [_smooth_png_bytes(10 + i) for i in range(3)]
        arrs = [np.asarray(svc._transform(Image.open(io.BytesIO(b)).convert("RGB")), np.float32)
                for b in bodies]
        direct = svc._run_batch(arrs)
        padded = torch.from_numpy(np.stack(arrs + [arrs[0]]))
        ref_lin, ref_clu = tinf.make_predict_step(svc.ecfg)(svc._model, padded)
        for i, (lin, clu) in enumerate(direct):
            np.testing.assert_array_equal(lin, ref_lin[i].numpy())
            np.testing.assert_array_equal(clu, ref_clu[i].numpy())
        assert not np.array_equal(direct[0][1], direct[1][1])

        outs = [None] * 3
        threads = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, svc.segment_bytes(bodies[i]))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        snap = svc.batcher.metrics.snapshot()
        one_batch = snap["batches"] == 2  # the direct call, then one window
        if one_batch:
            assert snap["pad_fraction"] == 0.25 and snap["mean_batch_occupancy"] == 3.0
        for got, ref in zip(outs, direct):
            for g, r in zip(got, ref):
                # in one bucket of 4 the rows' order may differ, not their values;
                # split over other buckets a GEMM may round differently
                assert (g == r).mean() >= (1.0 if one_batch else 0.995)
    finally:
        svc.close()


def test_http_server_routes_and_batching():
    svc = _tiny_service(max_wait_ms=250.0)
    server = serve_http(svc, port=0)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        svc.warmup(buckets=(4,))

        health = json.loads(urllib.request.urlopen(f"{base}/healthz").read())
        assert health["status"] == "ok"

        # three concurrent posts inside one window -> one device batch
        outs = [None] * 3

        def post(i):
            req = urllib.request.Request(
                f"{base}/v1/segment?format=npz", data=_png_bytes(i),
                method="POST")
            outs[i] = urllib.request.urlopen(req, timeout=60).read()

        before = svc.batcher.metrics.snapshot()["batches"]
        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        after = svc.batcher.metrics.snapshot()
        assert after["batches"] - before < 3
        for out in outs:
            blob = np.load(io.BytesIO(out))
            assert blob["linear"].shape == (32, 32)
            assert blob["cluster"].dtype == np.int32

        # png + json formats and the error paths
        req = urllib.request.Request(
            f"{base}/v1/segment?format=png&probe=linear",
            data=_png_bytes(9), method="POST")
        png = urllib.request.urlopen(req, timeout=60).read()
        from PIL import Image

        assert Image.open(io.BytesIO(png)).size == (32, 32)

        req = urllib.request.Request(
            f"{base}/v1/segment?format=json", data=_png_bytes(9),
            method="POST")
        js = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert len(js["cluster"]) == 32
        np.testing.assert_array_equal(np.asarray(js["linear"], np.uint8),
                                      np.asarray(Image.open(io.BytesIO(png))))

        for bad, code in ((f"{base}/v1/segment?format=bmp", 400),
                          (f"{base}/v1/segment?format=png&probe=liner", 400),
                          (f"{base}/v1/nope", 404)):
            req = urllib.request.Request(bad, data=_png_bytes(2),
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=60)
            assert exc.value.code == code
        for body in (b"", b"not an image"):
            req = urllib.request.Request(f"{base}/v1/segment", data=body,
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=60)
            assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{base}/nothing", timeout=60)
        assert exc.value.code == 404

        # a failing device step is the server's fault: 500, and it goes on
        svc.batcher._run_batch = lambda items: (_ for _ in ()).throw(RuntimeError("device"))
        req = urllib.request.Request(f"{base}/v1/segment", data=_png_bytes(2), method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=60)
        assert exc.value.code == 500
        svc.batcher._run_batch = svc._run_batch

        metrics = json.loads(urllib.request.urlopen(f"{base}/metrics").read())
        assert metrics["requests"] >= 5 and metrics["errors"] == 1
        assert set(metrics) == {"requests", "errors", "batches", "mean_batch_occupancy",
                                "pad_fraction", "latency_ms_p50", "latency_ms_p99"}
    finally:
        server.shutdown()
        svc.close()


def test_loadgen_drives_the_server():
    svc = _tiny_service(max_batch=4, max_wait_ms=5.0)
    server = serve_http(svc, port=0)
    try:
        out = serve_loadgen.run(f"http://127.0.0.1:{server.server_address[1]}",
                                _png_bytes(3), clients=3, seconds=1.0)
        assert out["errors"] == 0 and out["completed"] >= 3 and out["clients"] == 3
        assert out["img_per_sec"] > 0 and out["latency_ms_p50"] <= out["latency_ms_p99"]
        assert out["server_metrics"]["requests"] == out["completed"]
        assert out["server_metrics"]["batches"] <= out["completed"]
    finally:
        server.shutdown()
        svc.close()


def _export_tiny_ckpt(path, run_cfg):
    """A full-size ViT-S/8 checkpoint (the run config carries only the arch
    keys, so the service reconstructs the default backbone shape)."""
    fcfg = tfeat.FeaturizerConfig(dim=16)
    model = tinf.Segmenter(fcfg, 5, 7).init_weights(torch.Generator().manual_seed(0))
    export_lightning_ckpt(str(path), model.state_dict(), cfg=run_cfg)
    return model


def test_build_service_from_exported_checkpoint(tmp_path):
    """The CLI glue: export_lightning_ckpt -> build_service -> one request."""
    ckpt = tmp_path / "seg.ckpt"
    model = _export_tiny_ckpt(ckpt, {"model_type": "vit_small", "dino_patch_size": 8,
                                     "dim": 16, "n_classes": 5})
    cfg = load_config("serve_config.yml",
                      [f"model_path={ckpt}", "res=32", "run_crf=False",
                       "max_batch=2", "max_wait_ms=5", "warmup=False"])
    svc = tserve.build_service(cfg, "cpu")
    try:
        assert svc.ecfg.extra_clusters == 2 and svc.ecfg.n_classes == 5
        assert svc.ecfg.backbone_dtype == "bfloat16" and svc.ecfg.fused_tta
        body = _png_bytes(3)
        linear, cluster = svc.segment_bytes(body)
        assert linear.shape == (32, 32) and int(cluster.max()) < 7
        for k, v in model.state_dict().items():
            assert torch.equal(svc._model.state_dict()[k], v), k
    finally:
        svc.close()


def test_build_service_refuses_what_is_not_ported(tmp_path, monkeypatch):
    ckpt = tmp_path / "seg.ckpt"
    _export_tiny_ckpt(ckpt, {"model_type": "vit_small", "dim": 16, "n_classes": 5})
    base = [f"model_path={ckpt}", "res=32", "run_crf=False", "max_batch=8"]
    with pytest.raises(ValueError, match="multiple of the 3 devices"):
        tserve.build_service(load_config("serve_config.yml", base + ["n_devices=3"]), "cpu")
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError, match="CUDA device"):
            tserve.build_service(load_config("serve_config.yml", base + ["n_devices=8"]))
    orbax_dir = tmp_path / "native"
    orbax_dir.mkdir()
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        tserve.build_service(load_config("serve_config.yml", [f"model_path={orbax_dir}"]), "cpu")
    monkeypatch.setitem(__import__("sys").modules, "tensorstore", None)
    with pytest.raises(NotImplementedError, match="tensorstore"):
        tserve.build_service(load_config("serve_config.yml", [f"model_path={orbax_dir}"]), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            tserve.build_service(load_config("serve_config.yml", base))
    svc = tserve.build_service(load_config("serve_config.yml", base + ["n_devices=1"]), "cpu")
    svc.close()


def test_kernel_launch_counters_are_exact_across_threads():
    """The replicas' threads count their launches through one lock: 8
    threads x 20,000 counts each lose none."""
    from depthg_tpu_torch.ops import attention as tatt
    from depthg_tpu_torch.ops import crf_bilateral as tbil

    before = (tatt.KERNEL.launches, tatt.KERNEL.bias_launches, tatt.KERNEL.f32_launches,
              tbil.KERNEL.launches)

    def run():
        for _ in range(20_000):
            tatt.KERNEL.count(True, False)
            tbil.KERNEL.count()

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    after = (tatt.KERNEL.launches, tatt.KERNEL.bias_launches, tatt.KERNEL.f32_launches,
             tbil.KERNEL.launches)
    assert [a - b for a, b in zip(after, before)] == [160_000] * 4


@pytest.mark.parametrize("run_crf", [False, True])
def test_two_replicas_serve_what_one_device_serves(run_crf):
    """``devices=["cpu", "cpu"]``: buckets are multiples of 2, each padded
    batch is split across the two replicas (each on its own thread), and
    every response equals the single-device service's; 15 is no multiple
    of 2."""
    ecfg = tinf.EvalConfig(n_classes=5, run_crf=run_crf, label_res=32)
    with pytest.raises(ValueError, match="multiple of the 2 devices"):
        SegmentationService(_tiny_model(), ecfg, res=32, max_batch=15, devices=["cpu", "cpu"])
    one = SegmentationService(_tiny_model(), ecfg, res=32, max_batch=8, max_wait_ms=1.0,
                              device="cpu")
    two = SegmentationService(_tiny_model(), ecfg, res=32, max_batch=8, max_wait_ms=1.0,
                              devices=["cpu", "cpu"])
    try:
        assert two._min_bucket == 2 and two.warmup() == [2, 4, 8]
        assert len(two._models) == 2 and two._models[0] is not two._models[1]
        for k, v in two._models[0].state_dict().items():
            assert torch.equal(two._models[1].state_dict()[k], v), k
        for n in (1, 3, 4):  # buckets 2, 4, 4
            arrs = [np.asarray(two._transform(_png_image(20 + i)), np.float32)
                    for i in range(n)]
            b = tserve._bucket(n, 8, 2)
            got, ref = two._run_batch(arrs), one._predict_padded(arrs, b)
            for i, (lin, clu) in enumerate(got):
                np.testing.assert_array_equal(lin, ref[0][i])
                np.testing.assert_array_equal(clu, ref[1][i])
        lin, clu = two.segment_bytes(_png_bytes(4))
        ref = one.segment_bytes(_png_bytes(4))
        np.testing.assert_array_equal(lin, ref[0])
        np.testing.assert_array_equal(clu, ref[1])
    finally:
        one.close()
        two.close()


@pytest.mark.parametrize("run_crf", [False, True])
def test_served_labels_match_jax_service(run_crf):
    """The same PNG bytes through both packages' services, float32, weights
    carried with ``state_dict_from_jax``: 100% of labels without the CRF,
    >= 99.5% with it (the int8 roundings of the CRF's kernel cache can land
    one step apart between frameworks, see test_torch_crf)."""
    res = 64
    vit = dict(TINY, img_size=res)
    fj = jfeat.FeaturizerConfig(arch="vit_small", patch_size=8, dim=16,
                                vit_config=jvit.ViTConfig(**vit))
    ft = tfeat.FeaturizerConfig(dim=16, vit_config=tvit.ViTConfig(**vit))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"net": jfeat.featurizer_init(k1, fj),
              "linear_probe": jprobes.linear_probe_init(k2, 16, 5),
              "cluster_probe": jprobes.cluster_lookup_init(k3, 16, 5)}
    import dataclasses

    ej = jinf.EvalConfig(n_classes=5, run_crf=run_crf, label_res=res, precision="highest",
                         crf=dataclasses.replace(jcrf.crf_config_from_cfg({}), dtype="float32"))
    et = tinf.EvalConfig(n_classes=5, run_crf=run_crf, label_res=res,
                         crf=dataclasses.replace(tcrf.crf_config_from_cfg({}), dtype="float32"))
    jsvc = jserve.SegmentationService(params, fj, ej, res=res, max_batch=2, max_wait_ms=1.0)
    tsvc = SegmentationService(tinf.Segmenter.from_state_dict(state_dict_from_jax(params), ft),
                               et, res=res, max_batch=2, max_wait_ms=1.0, device="cpu")
    try:
        agree = []
        for seed in range(4):
            body = _smooth_png_bytes(seed)
            ref = jsvc.segment_bytes(body)
            out = tsvc.segment_bytes(body)
            for o, r in zip(out, ref):
                assert o.shape == np.asarray(r).shape == (res, res)
                agree.append(float((o == np.asarray(r)).mean()))
        print("label agreement per probe and image:", agree)
        assert min(agree) >= (0.995 if run_crf else 1.0), agree
    finally:
        jsvc.close()
        tsvc.close()
