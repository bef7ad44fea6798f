"""On-device NMS vs darknet CPU NMS; mAP evaluator sanity."""

import numpy as np
import pytest
import jax.numpy as jnp

from yolotpu import eval as yeval
from yolotpu.ops import nms as dnms
from yolotpu.postprocess import Detection, do_nms_sort


def _random_scene(rng, n=40, classes=5):
    boxes = np.stack([rng.uniform(0.2, 0.8, n), rng.uniform(0.2, 0.8, n),
                      rng.uniform(0.05, 0.3, n), rng.uniform(0.05, 0.3, n)],
                     axis=1).astype(np.float32)
    obj = rng.uniform(0, 1, n).astype(np.float32)
    probs = rng.dirichlet(np.ones(classes), n).astype(np.float32)
    return boxes, obj, probs


def test_device_nms_matches_darknet_cpu():
    rng = np.random.default_rng(0)
    boxes, obj, probs = _random_scene(rng)
    thresh, nt = 0.2, 0.45

    # darknet CPU reference over the same candidates
    dets = []
    for i in range(boxes.shape[0]):
        p = obj[i] * probs[i]
        p = np.where(p > thresh, p, 0.0).astype(np.float32)
        if obj[i] > thresh:
            dets.append(Detection(bbox=tuple(boxes[i]), objectness=obj[i],
                                  prob=p.copy(), classes=probs.shape[1]))
    ref = do_nms_sort(dets, probs.shape[1], nt)
    ref_set = {}
    for d in ref:
        j, p = d.best_class()
        if p > thresh:
            ref_set[tuple(np.round(d.bbox, 5))] = (j, round(float(p), 5))

    sb, ss, sc, sv, _sat = dnms.topk_decode_nms(
        jnp.asarray(boxes)[None], jnp.asarray(obj)[None],
        jnp.asarray(probs)[None], thresh, nt, topk=40)
    got = {}
    for i in range(sb.shape[1]):
        if bool(sv[0, i]) and float(ss[0, i]) > thresh:
            got[tuple(np.round(np.asarray(sb[0, i]), 5))] = (
                int(sc[0, i]), round(float(ss[0, i]), 5))
    assert got == ref_set


def test_device_nms_suppression_basic():
    boxes = jnp.asarray([[[0.5, 0.5, 0.4, 0.4],
                          [0.52, 0.5, 0.4, 0.4],
                          [0.9, 0.9, 0.1, 0.1]]], jnp.float32)
    obj = jnp.asarray([[0.9, 0.8, 0.7]], jnp.float32)
    probs = jnp.asarray([[[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]]], jnp.float32)
    sb, ss, sc, sv, _sat = dnms.topk_decode_nms(boxes, obj, probs, 0.3, 0.45, topk=3)
    valid = [(float(ss[0, i]), int(sc[0, i])) for i in range(3) if bool(sv[0, i])]
    # box1 suppressed by box0 (same class, IoU ~0.82); box2 other class kept
    assert len(valid) == 2
    assert valid[0][1] == 0 and abs(valid[0][0] - 0.9) < 1e-5
    assert valid[1][1] == 1


def test_map_perfect_and_degraded():
    rng = np.random.default_rng(1)
    gts, preds = [], []
    for _ in range(4):
        boxes = np.stack([rng.uniform(0.3, 0.7, 6), rng.uniform(0.3, 0.7, 6),
                          rng.uniform(0.1, 0.2, 6), rng.uniform(0.1, 0.2, 6)],
                         1).astype(np.float32)
        cls = rng.integers(0, 3, 6).astype(np.int32)
        gts.append(yeval.GroundTruth(boxes=boxes, classes=cls))
        preds.append(yeval.Prediction(boxes=boxes.copy(), classes=cls.copy(),
                                      scores=np.linspace(1, 0.5, 6).astype(np.float32)))
    r = yeval.map_coco(preds, gts, 3)
    assert r["mAP_50"] > 0.99 and r["mAP_50_95"] > 0.99

    # shift all predictions: IoU drops, strict thresholds fail first
    for p in preds:
        p.boxes[:, 0] += 0.05
    r2 = yeval.map_coco(preds, gts, 3)
    assert r2["mAP_50"] <= r["mAP_50"] + 1e-9
    assert r2["mAP_50_95"] < r["mAP_50_95"]
    assert r2["per_iou"][0.9] <= r2["per_iou"][0.5]


def test_ap_counts_false_positives():
    gt = yeval.GroundTruth(boxes=np.asarray([[0.5, 0.5, 0.2, 0.2]], np.float32),
                           classes=np.asarray([0], np.int32))
    pred = yeval.Prediction(
        boxes=np.asarray([[0.5, 0.5, 0.2, 0.2], [0.1, 0.1, 0.2, 0.2]], np.float32),
        classes=np.asarray([0, 0], np.int32),
        scores=np.asarray([0.9, 0.95], np.float32))
    r = yeval.ap_voc([pred], [gt], 1)
    # FP ranked above the TP: precision at recall 1.0 is 0.5
    assert abs(r["mAP"] - 0.5) < 1e-6


def test_darknet_label_io(tmp_path):
    p = tmp_path / "img.txt"
    p.write_text("2 0.5 0.5 0.25 0.3\n7 0.1 0.2 0.05 0.05\n")
    gt = yeval.load_darknet_labels(str(p))
    assert gt.boxes.shape == (2, 4)
    assert list(gt.classes) == [2, 7]
    empty = yeval.load_darknet_labels(str(tmp_path / "missing.txt"))
    assert empty.boxes.shape == (0, 4)


def test_device_check_cpu():
    from yolotpu.cli.device_check import main
    assert main(["enumerate", "alloc", "compute", "latency"]) == 0


@pytest.mark.slow
def test_engine_device_nms_matches_host_path():
    """device_nms engine and host postprocess agree on kept detections."""
    from yolotpu.models import zoo
    from yolotpu.runtime.engine import Engine, load_or_synthesize
    spec = zoo.build("yolov2", width=64, height=64)
    store = load_or_synthesize(spec, None, "fp32", synthetic=True)
    rng = np.random.default_rng(3)
    img = rng.random((3, 96, 128)).astype(np.float32)

    host_eng = Engine(spec, store, "fp32", backend="xla")
    dev_eng = Engine(spec, store, "fp32", backend="xla", device_nms=True,
                     thresh=0.25, nms=0.45)
    import os
    os.environ["YOLO2_NO_DUMP"] = "1"
    try:
        host_dets, _ = host_eng.detect(img, 0.25, 0.45)
        dev_dets, _ = dev_eng.detect_device(img)
    finally:
        os.environ.pop("YOLO2_NO_DUMP")

    host = {}
    for d in host_dets:
        j, p = d.best_class()
        if p > 0.25:
            host[tuple(np.round(d.bbox, 4))] = (j, round(p, 4))
    dev = {}
    for d in dev_dets:
        j, p = d.best_class()
        dev[tuple(np.round(d.bbox, 4))] = (j, round(p, 4))
    assert dev == host


def test_device_nms_dense_scene_topk256():
    """VERDICT #7: a scene with far more than 64 above-threshold candidates
    must match the host path exactly at the default K=256, and the
    saturation flag must fire when K is too small."""
    rng = np.random.default_rng(42)
    n, classes = 400, 8
    boxes, obj, probs = _random_scene(rng, n=n, classes=classes)
    boxes[:, 2:] = rng.uniform(0.02, 0.08, (n, 2))      # small, low-overlap
    # peaked class distributions so obj*p clears the threshold often
    probs = np.full((n, classes), 0.1 / (classes - 1), np.float32)
    probs[np.arange(n), rng.integers(0, classes, n)] = 0.9
    # exactly half the candidates above threshold: fits K=256, busts K=64
    obj = np.where(np.arange(n) % 2 == 0,
                   rng.uniform(0.5, 1.0, n),
                   rng.uniform(0.0, 0.25, n)).astype(np.float32)
    thresh, nt = 0.3, 0.45

    dets = []
    for i in range(n):
        p = (obj[i] * probs[i]).astype(np.float32)
        p = np.where(p > thresh, p, 0.0).astype(np.float32)
        dets.append(Detection(bbox=tuple(boxes[i]), objectness=obj[i],
                              prob=p.copy(), classes=classes))
    ref = do_nms_sort(dets, classes, nt)
    ref_set = {}
    for d in ref:
        j, p = d.best_class()
        if p > thresh:
            ref_set[tuple(np.round(d.bbox, 5))] = (j, round(float(p), 5))
    assert len(ref_set) > 64, "fixture must be dense enough to bust K=64"

    sb, ss, sc, sv, sat = dnms.topk_decode_nms(
        jnp.asarray(boxes)[None], jnp.asarray(obj)[None],
        jnp.asarray(probs)[None], thresh, nt, topk=256)
    assert not bool(sat[0]), "K=256 must not saturate on 400 candidates"
    got = {}
    for i in range(sb.shape[1]):
        if bool(sv[0, i]) and float(ss[0, i]) > thresh:
            got[tuple(np.round(np.asarray(sb[0, i]), 5))] = (
                int(sc[0, i]), round(float(ss[0, i]), 5))
    assert got == ref_set

    # the old K=64 default silently truncated; now it must raise the flag
    *_, sat64 = dnms.topk_decode_nms(
        jnp.asarray(boxes)[None], jnp.asarray(obj)[None],
        jnp.asarray(probs)[None], thresh, nt, topk=64)
    assert bool(sat64[0])


def test_evaluate_engine_batched_matches_unbatched(tmp_path, monkeypatch):
    """The batched-device evaluator (uint8 NHWC frames through
    predict_batch_rgb, host postprocess) scores identically to the
    per-image ``evaluate_engine`` path on net-sized protocol scenes."""
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    from yolotpu import accuracy as acc
    from yolotpu import eval as yeval
    from yolotpu.models import zoo
    from yolotpu.runtime.engine import Engine, load_or_synthesize
    spec = zoo.build("yolov2", width=64, height=64)
    store = load_or_synthesize(spec, None, "fp32", synthetic=True)
    eng = Engine(spec, store, "fp32", backend="xla")
    pairs = acc.write_eval_set(str(tmp_path / "ev"), 64)[:6]
    rb = yeval.evaluate_engine_batched(eng, pairs, num_classes=80,
                                       thresh=0.05, batch=4)
    ru = yeval.evaluate_engine(eng, pairs, num_classes=80, thresh=0.05)
    assert rb["images"] == ru["images"] == 6
    assert rb["mAP_50"] == ru["mAP_50"]
    assert rb["mAP_50_95"] == ru["mAP_50_95"]


def test_evaluate_engine_batched_rejects_non_net_sized(tmp_path):
    from PIL import Image
    from yolotpu import eval as yeval
    from yolotpu.models import zoo
    from yolotpu.runtime.engine import Engine, load_or_synthesize
    spec = zoo.build("yolov2", width=64, height=64)
    store = load_or_synthesize(spec, None, "fp32", synthetic=True)
    eng = Engine(spec, store, "fp32", backend="xla")
    ip = str(tmp_path / "odd.png")
    Image.fromarray(np.zeros((48, 80, 3), np.uint8)).save(ip)
    with pytest.raises(ValueError, match="net-sized"):
        yeval.evaluate_engine_batched(eng, [(ip, ip + ".txt")],
                                      num_classes=80)
