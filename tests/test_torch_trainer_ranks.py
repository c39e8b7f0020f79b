"""The port's Trainer on several ranks (cocodet_tpu_torch/core/trainer.py,
cocodet_tpu/core/trainer.py:154-252, :328-351, :395-407), through the CLI's
rank spawning (``tools/train.py -d 2``): 2 gloo ranks on the CPU, as a 1-D
data mesh and as a (1 data x 2 space) mesh, each against the single-rank
trainer on the same command. The exp is tests/test_torch_trainer.py's tiny
phase-1 exp with device mosaic on 256/384 px buckets (the least sizes the
space axis admits), 4 synthetic train and 2 val JPEGs, B=2, one mosaic
epoch and one no-aug epoch of 2 iterations, an evaluation and checkpoints
after each.

The trained model is f64 (``tests/torch_trainer_ranks.py::f64_hook``). In
f32 the ranks' sums of a BN-fed conv's gradient cancel in another order
than one process's: the update of the step after the first differed by
2.5% of its norm, and the next step's loss by 1.7% once SimOTA assigned
otherwise (measured on this exp at 128/192 px). In f64 the losses agree to
1e-4 relative, the tolerance held here.

Held: each rank's preprocessed slice, concatenated over the data rows (and
over the space rows along the height), equals the single-rank batch bit for
bit; each iteration's lr, size and ``use_l1`` equal; the losses within 1e-4
relative; the ranks' parameters, BN statistics, EMA and optimizer state
bit for bit equal (and their digests); only rank 0 writes checkpoints, the
single rank's files; each rank evaluates its share of the val set, and the
gathered records and AP agree on both ranks; the gathered records are the
single rank's, one for one (image and category exact, scores within 1e-5
and boxes within 1e-3 px: the EMA the evaluator reads differs by the f64
state's rounding, measured 1.3e-6 and 3.3e-4 px on this exp)."""

import os

import numpy as np
import pytest

import torch_trainer_ranks as tr
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.tools import train

MESHES = ("1-D", "2-D")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    root = make_synthetic_coco(os.path.join(tmp, "coco"), n_train=4, n_val=2,
                               size_range=(64, 128), seed=0)
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
        single = train.main(tr.argv(root, os.path.join(tmp, "single")), rank_hook=tr.f64_hook)
        out = {"single": {**tr.f64_hook(single, "end"), "trainer": single}}
        single.after_train()
    finally:
        mp.undo()
    out["1-D"] = train.main(tr.argv(root, os.path.join(tmp, "d1"), "-d", "2"),
                            rank_hook=tr.f64_hook)
    out["2-D"] = train.main(tr.argv(root, os.path.join(tmp, "d2"), "-d", "2",
                                    "spatial_devices", "2"), rank_hook=tr.f64_hook)
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_rank_slices_concatenate_to_the_single_batch(runs, mesh):
    want = runs["single"]["steps"]
    ranks = [r["hook"]["steps"] for r in runs[mesh].ranks]
    assert len(want) == 4 and all(len(r) == 4 for r in ranks)
    for k, (imgs, labels) in enumerate(want):
        parts = [r[k] for r in ranks]
        if mesh == "1-D":
            got_imgs = np.concatenate([p[0] for p in parts])
            got_labels = np.concatenate([p[1] for p in parts])
        else:  # one data row: both ranks hold its labels and half its rows each
            got_imgs = np.concatenate([p[0] for p in parts], axis=1)
            got_labels = parts[0][1]
            assert tr.same_arrays(parts[1][1], got_labels)
        assert tr.same_arrays(got_imgs, imgs), k
        assert tr.same_arrays(got_labels, labels), k


@pytest.mark.parametrize("mesh", MESHES)
def test_rank_losses_and_bookkeeping_match_the_single_rank(runs, mesh):
    want = runs["single"]["log"]
    assert {r["size"] for r in want} <= {(256, 256), (384, 384)}
    assert [r["use_l1"] for r in want] == [False, False, True, True]
    for r in runs[mesh].ranks:
        got = r["hook"]["log"]
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert (a["epoch"], a["it"], a["size"], a["use_l1"], a["lr"]) == (
                b["epoch"], b["it"], b["size"], b["use_l1"], b["lr"])
            for k in tr.LOSSES:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=0, err_msg=k)
            assert np.isfinite(a["loss"]) and a["loss"] != 0


@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_hold_one_state(runs, mesh):
    a, b = (r["hook"] for r in runs[mesh].ranks)
    assert runs[mesh].ranks[0]["digest"] == runs[mesh].ranks[1]["digest"]
    assert sorted(a["variables"]) == sorted(b["variables"])
    for k in a["variables"]:
        assert tr.same_arrays(a["variables"][k], b["variables"][k]), k
    for k in a["ema"]:
        assert tr.same_arrays(a["ema"][k], b["ema"][k]), k
    assert a["count"] == b["count"] == runs["single"]["count"] == 4
    # the ranks trained the single rank's model: one f64 state apart by rounding
    single = runs["single"]["variables"]
    for k, v in a["variables"].items():
        np.testing.assert_allclose(v, single[k], rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_only_rank_0_writes_checkpoints(runs, mesh):
    r0, r1 = runs[mesh].ranks
    assert [c["name"] for c in r0["ckpt_stats"]] == ["latest", "epoch_1", "latest", "epoch_2"]
    assert r1["ckpt_stats"] == []
    assert r0["hook"]["files"] == runs["single"]["files"]
    assert runs[mesh].ckpt_stats == r0["ckpt_stats"]  # rank 0's bookkeeping on the run


@pytest.mark.parametrize("mesh", MESHES)
def test_evaluation_is_sharded_and_gathered(runs, mesh):
    r0, r1 = runs[mesh].ranks
    assert [e["images"] for e in r0["eval_stats"]] == [(0, 1), (0, 1)]
    assert [e["images"] for e in r1["eval_stats"]] == [(1, 2), (1, 2)]
    for e0, e1 in zip(r0["eval_stats"], r1["eval_stats"]):
        assert (e0["records"], e0["AP"], e0["AP50"]) == (e1["records"], e1["AP"], e1["AP50"])
    assert r0["best_ap"] == r1["best_ap"]
    single = runs["single"]["trainer"].eval_stats
    assert [e["images"] for e in single] == [(0, 2), (0, 2)]
    # the gathered records are the single rank's: none dropped or repeated
    got, want = (tr.record_rows(h["records"]) for h in (r0["hook"], runs["single"]))
    assert got == tr.record_rows(r1["hook"]["records"])
    assert len(got) == len(want) == single[-1]["records"] == r0["eval_stats"][-1]["records"] > 0
    got, want = np.array(got, np.float64), np.array(want, np.float64)
    assert (got[:, :2] == want[:, :2]).all()
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=1e-5)  # scores
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=0, atol=1e-3)  # boxes, px
