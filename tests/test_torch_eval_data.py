"""The port's data pipeline of the evaluation family against the JAX
package's: cocodet_tpu_torch/data/{coco,folder,synthetic}.py.

Tolerances: none for what must be exact (sizes, annotations, image
ids, ``probe_image_size``, ``list_images``, ``exposure_normalize``, the
synthetic set's JSON but for ``file_name``). The dataset items' pixels are
held exactly too: the port's resize equals cv2.resize on every pixel and
its letterbox is the JAX native one (tests/test_torch_image_io.py). The
numpy rasterizer differs from cv2's drawing on edge pixels only: the
filled circle and rectangle on none, the filled ellipse, the triangle and
the thick ellipse outline on a stated share of the pixels either draws
(on this test's 40 draws of each: 0.69%, 0.62% and 4.56%; the limits
are 1%, 1% and 5%).
"""

import json
import os

import cv2
import numpy as np
import pytest

from cocodet_tpu.data import coco as jcoco
from cocodet_tpu.data import folder as jfolder
from cocodet_tpu.data import synthetic as jsynth
from cocodet_tpu.data.transforms import ValTransform as JaxVal
from cocodet_tpu_torch.data import coco, folder, synthetic
from cocodet_tpu_torch.data.image_io import write_image
from cocodet_tpu_torch.data.transforms import ValTransform
from torch_port_utils import private_native_builds


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's native letterbox, built for this process before any JAX
    reference runs (tests/torch_port_utils.py::private_native_builds)."""
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths


@pytest.fixture(scope="module")
def png_set(tmp_path_factory):
    """The port's synthetic val set (PNG), 6 images of 64-200 px."""
    root = str(tmp_path_factory.mktemp("synth"))
    return synthetic.make_synthetic_coco(root, n_train=0, n_val=6, size_range=(64, 200),
                                         seed=3)


@pytest.mark.parametrize("preproc", [None, "val"])
def test_coco_dataset_items_match_jax(png_set, preproc):
    kw = dict(data_dir=png_set, json_file="instances_val2017.json", name="val2017",
              img_size=(160, 128))
    got = coco.COCODataset(**kw, preproc=ValTransform() if preproc else None)
    want = jcoco.COCODataset(**kw, preproc=JaxVal() if preproc else None)
    assert got.ids == want.ids and len(got) == 6
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g[2] == w[2] and g[3] == w[3]
        assert g[0].dtype == w[0].dtype and g[0].shape == w[0].shape
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert got.annotations[i][2] == want.annotations[i][2]


def test_coco_annotations_match_jax(png_set):
    ann = os.path.join(png_set, "annotations", "instances_val2017.json")
    got, want = coco.COCOAnnotations(ann), jcoco.COCOAnnotations(ann)
    assert got.ids == want.ids and got.cat_to_contig == want.cat_to_contig
    for i in got.ids:
        np.testing.assert_array_equal(got.boxes_for(i), want.boxes_for(i))
    assert coco.COCO_CLASS_ID == jcoco.COCO_CLASS_ID
    assert coco.COCO_CLASSES == jcoco.COCO_CLASSES


@pytest.mark.parametrize("exposure_norm", [False, True])
def test_image_folder_items_match_jax(png_set, exposure_norm):
    d = os.path.join(png_set, "val2017")
    got = folder.ImageFolderDataset(d, 192, exposure_norm)
    want = jfolder.ImageFolderDataset(d, 192, exposure_norm)
    assert got.files == want.files
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g[1] == w[1]
        np.testing.assert_array_equal(g[0], w[0])
    items_g, items_w = [got[i] for i in range(4)], [want[i] for i in range(4)]
    for (bg, ig), (bw, iw) in zip([folder.collate_batch(192, items_g)],
                                  [jfolder.collate_batch(192, items_w)]):
        assert ig == iw and bg.dtype == bw.dtype
        np.testing.assert_array_equal(bg, bw)
    for (bg, ig), (bw, iw) in zip(folder.FolderLoader(got, 4), jfolder.FolderLoader(want, 4)):
        assert ig == iw
        np.testing.assert_array_equal(bg, bw)


def test_probe_and_list_images_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    for name, (h, w) in {"a.png": (17, 33), "b.jpg": (40, 21), "c.bmp": (9, 12),
                         "d.tif": (11, 7), "e.webp": (30, 50)}.items():
        cv2.imwrite(str(tmp_path / name), rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
    write_image(str(tmp_path / "f.png"), rs.randint(0, 256, (5, 6, 3)).astype(np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    for f in sorted(os.listdir(tmp_path)):
        assert folder.probe_image_size(str(tmp_path / f)) == \
            jfolder.probe_image_size(str(tmp_path / f)), f
    got = folder.list_images(str(tmp_path))
    assert got == jfolder.list_images(str(tmp_path))
    assert [g[0] for g in got] == ["a.png", "b.jpg", "c.bmp", "d.tif", "e.webp", "f.png"]


def test_list_images_raises_on_unreadable_header(tmp_path):
    """Where the JAX package falls back to a full cv2 decode (and skips the
    file if that fails too), the port raises."""
    (tmp_path / "broken.png").write_bytes(b"not a png at all")
    assert jfolder.list_images(str(tmp_path)) == []
    with pytest.raises(ValueError, match="broken.png"):
        folder.list_images(str(tmp_path))


@pytest.mark.parametrize("gain", [1.0, 0.45, 0.3, 0.18])
def test_exposure_normalize_matches_jax(gain):
    img = (np.random.RandomState(1).randint(0, 256, (40, 50, 3)) * gain).astype(np.uint8)
    got, want = folder.exposure_normalize(img), jfolder.exposure_normalize(img)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", list(jsynth.VARIANTS))
def test_synthetic_annotations_match_jax(tmp_path, variant):
    got = synthetic.make_synthetic_coco(str(tmp_path / "port"), n_train=2, n_val=3,
                                        size_range=(64, 160), variant=variant, seed=7)
    want = jsynth.make_synthetic_coco(str(tmp_path / "jax"), n_train=2, n_val=3,
                                      size_range=(64, 160), variant=variant, seed=7)
    for split in ("train2017", "val2017"):
        jg, jw = (json.load(open(os.path.join(r, "annotations", f"instances_{split}.json")))
                  for r in (got, want))
        assert jg == jw  # file_name included: the port writes JAX's {i:012d}.jpg
        names = [im["file_name"] for im in jg["images"]]
        assert names == [f"{i:012d}.jpg" for i in range(len(names))]
        for name, im in zip(names, jg["images"]):
            img = cv2.imread(os.path.join(got, split, name))
            assert img.shape == (im["height"], im["width"], 3)
    assert synthetic.SYNTH_CLASSES == jsynth.SYNTH_CLASSES


# the share of pixels either rasterizer draws that differ, at most
RASTER_SHARE = {"circle": 0.0, "rectangle": 0.0, "ellipse": 0.01, "triangle": 0.01,
                "ring": 0.05}


@pytest.mark.parametrize("shape", list(RASTER_SHARE))
def test_rasterizer_against_cv2(shape):
    rs = np.random.RandomState(0)
    differ = drawn = 0
    for _ in range(40):
        h, w = 200, 240
        cx, cy = int(rs.randint(0, w)), int(rs.randint(0, h))
        r = int(rs.randint(4, 60))
        ax, ay = int(rs.randint(3, 90)), int(rs.randint(3, 90))
        t = max(int(min(ax, ay) * 0.35), 2)
        tri = np.asarray([[cx + rs.uniform(-20, 20), cy - ay], [cx - ax, cy + ay],
                          [cx + ax, cy + ay]], np.int32)
        col = tuple(int(v) for v in rs.randint(1, 256, 3))
        want, got = np.zeros((2, h, w, 3), np.uint8)
        if shape == "circle":
            cv2.circle(want, (cx, cy), r, col, -1)
            synthetic.circle(got, (cx, cy), r, col)
        elif shape == "rectangle":
            cv2.rectangle(want, (cx - r, cy - r), (cx + 2 * r, cy + r), col, -1)
            synthetic.rectangle(got, (cx - r, cy - r), (cx + 2 * r, cy + r), col)
        elif shape == "ellipse":
            cv2.ellipse(want, (cx, cy), (ax, ay), 0, 0, 360, col, -1)
            synthetic.ellipse(got, (cx, cy), (ax, ay), col, -1)
        elif shape == "triangle":
            cv2.fillPoly(want, [tri], col)
            synthetic.fill_poly(got, tri, col)
        else:
            cv2.ellipse(want, (cx, cy), (ax - t // 2, ay - t // 2), 0, 0, 360, col, t)
            synthetic.ellipse(got, (cx, cy), (ax - t // 2, ay - t // 2), col, t)
        differ += int((want != got).any(-1).sum())
        drawn += int(((want > 0) | (got > 0)).any(-1).sum())
    assert drawn > 10000
    assert differ <= RASTER_SHARE[shape] * drawn, (shape, differ, drawn, differ / drawn)
