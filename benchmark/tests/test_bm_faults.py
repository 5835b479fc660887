"""Each fault a cell can have, planted in the program under a run that
skips only the look for a card, turns `correct` false, and the number
meant to catch it is the one that fails."""

from __future__ import annotations

import time

import pytest
import torch

import depthg_tpu_torch.inference as inference
import depthg_tpu_torch.train.step as step_lib
from benchmark.drivers import eval as eval_driver
from benchmark.drivers import train as train_driver
from benchmark.run import verdict
from benchmark.tests._tiny import tiny_spec

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_cell(driver, cell):
    out = driver.run(tiny_spec(cell), seed=2 ** 31 + 17, seconds=0.5, trace=False, dev=CPU,
                     t_start=time.perf_counter())
    return out["checks"]


def test_eval_half_batch(monkeypatch):
    make = inference.make_eval_step

    def half(ecfg, group=None):
        step = make(ecfg, group)
        return lambda model, img, label: step(model, img[: len(img) // 2],
                                              label[: len(label) // 2])

    monkeypatch.setattr(inference, "make_eval_step", half)
    checks = run_cell(eval_driver, "vits8-eval-default")
    assert checks["count_gap"][0] > checks["count_gap"][1]
    assert not verdict(checks)


def test_eval_answer_altered(monkeypatch):
    predictions = inference.predictions

    def altered(model, img, ecfg):
        lin, clu = predictions(model, img, ecfg)
        return torch.cat([(lin[:1] + 1) % ecfg.n_classes, lin[1:]]), clu

    monkeypatch.setattr(inference, "predictions", altered)
    checks = run_cell(eval_driver, "vits8-eval-default")
    assert checks["label_gap"][0] > 5 * checks["label_gap"][1]
    assert checks["count_gap"][0] == 0
    assert not verdict(checks)


def test_train_state_unchanged(monkeypatch):
    train_step = step_lib.train_step

    def unchanged(state, batch, *args, **kwargs):
        keep = {k: v.detach().clone() for k, v in state.model.named_parameters()}
        logs = train_step(state, batch, *args, **kwargs)
        with torch.no_grad():
            for k, v in state.model.named_parameters():
                v.copy_(keep[k])
        return logs

    monkeypatch.setattr(step_lib, "train_step", unchanged)
    checks = run_cell(train_driver, "vits8-train-b32")
    assert checks["update_gap_median"][0] == pytest.approx(1.0)
    assert not verdict(checks)


def test_train_half_batch(monkeypatch):
    train_step = step_lib.train_step

    def half(state, batch, *args, **kwargs):
        return train_step(state, {k: v[: len(v) // 2] for k, v in batch.items()}, *args, **kwargs)

    monkeypatch.setattr(step_lib, "train_step", half)
    checks = run_cell(train_driver, "vits8-train-b32")
    assert checks["grad_gap"][0] > checks["grad_gap"][1]
    assert not verdict(checks)


def _serve_spec():
    from benchmark.tests._serve import serve_spec

    spec = serve_spec()
    spec["config"] = tiny_spec("vits8-eval-default")["config"]
    spec["traffic"] = dict(spec["traffic"], rate=4.0, bodies=4, sizes=[[96, 64], [64, 80]],
                           check_requests=3, wait_s=20.0)
    return spec


def run_serve():
    from benchmark.drivers import serve as serve_driver

    out = serve_driver.run(_serve_spec(), seed=2 ** 31 + 23, seconds=2.0, trace=False, dev=CPU,
                           t_start=time.perf_counter())
    return out["checks"]


def test_serve_answer_altered(monkeypatch):
    make = inference.make_predict_step

    def altered(ecfg, group=None):
        step = make(ecfg, group)

        def run(model, img):
            lin, clu = step(model, img)
            return (lin + 1) % ecfg.n_classes, clu
        return run

    monkeypatch.setattr(inference, "make_predict_step", altered)
    checks = run_serve()
    assert checks["label_gap"][0] > 0.5
    assert not verdict(checks)


def test_serve_answer_never_comes(monkeypatch):
    import depthg_tpu_torch.serve as serve

    segment = serve.SegmentationService.segment_bytes
    calls = []

    def flaky(self, body):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("dropped")
        return segment(self, body)

    monkeypatch.setattr(serve.SegmentationService, "segment_bytes", flaky)
    checks = run_serve()
    assert checks["missing"][0] == 1
    assert not verdict(checks)
