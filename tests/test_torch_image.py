"""The port's TFRecord codec and image pipeline (wide_deep_tpu_torch/
features/{tfrecord,image}.py) against the JAX package's: the same bytes read
and written, the same Examples, the same decoded and preprocessed pixels
from the same generator, the same batches; images pair with TSV rows by
their original index under shuffling and sharding.  Everything here is
exact (the port's copies run the same numpy code)."""

import numpy as np
import pytest

pytest.importorskip("torch")

from paths import IMAGE_TFRECORDS, UNIT_FIXTURE  # noqa: E402


def _port_plan(small_conf_dir):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    return FeaturePlan(Config(small_conf_dir))


def test_committed_tfrecord_parses_as_jax():
    from wide_deep_tpu.features import tfrecord as jtf
    from wide_deep_tpu_torch.features import tfrecord as ttf
    jrecs = list(jtf.read_records(IMAGE_TFRECORDS, verify=True))
    trecs = list(ttf.read_records(IMAGE_TFRECORDS, verify=True))
    assert len(trecs) == 24 and trecs == jrecs
    for payload in trecs:
        ex = ttf.parse_example(payload)
        assert ex == jtf.parse_example(payload)
        assert len(ex["image"][0]) == 224 * 224 * 3
    assert ttf.record_offsets(IMAGE_TFRECORDS) == jtf.record_offsets(
        IMAGE_TFRECORDS)


def test_write_gives_the_same_bytes(tmp_path):
    """The committed file written back by the port's writer is the same
    file, as JAX's writer makes it; Examples serialize to JAX's bytes."""
    from wide_deep_tpu.features import tfrecord as jtf
    from wide_deep_tpu_torch.features import tfrecord as ttf
    recs = list(ttf.read_records(IMAGE_TFRECORDS))
    assert ttf.write_records(str(tmp_path / "t"), iter(recs)) == 24
    jtf.write_records(str(tmp_path / "j"), iter(recs))
    whole = open(IMAGE_TFRECORDS, "rb").read()
    assert (tmp_path / "t").read_bytes() == whole
    assert (tmp_path / "j").read_bytes() == whole
    ex = {"image": [b"\x01\x02", b""], "label": [3, -1, -7, 2 ** 40],
          "score": list(np.asarray([0.25, 0.7, -1.9], np.float32)),
          "w": [0.5]}
    ser = ttf.serialize_example(ex)
    assert ser == jtf.serialize_example(ex)
    back = ttf.parse_example(ser)
    assert back == jtf.parse_example(ser)
    assert back["label"] == [3, -1, -7, 2 ** 40]
    assert np.array(back["label"], np.int64).tolist() == back["label"]
    np.testing.assert_allclose(back["score"], [0.25, 0.7, -1.9], rtol=1e-6)
    assert back["image"] == [b"\x01\x02", b""]


def test_truncated_record_raises(tmp_path):
    from wide_deep_tpu_torch.features import tfrecord as ttf
    path = str(tmp_path / "t.tfrecords")
    ttf.write_records(path, iter([b"payload-one", b"payload-two"]))
    whole = open(path, "rb").read()
    for cut_at in (len(whole) - 7, len(whole) - 30):   # payload, header
        cut = str(tmp_path / f"cut{cut_at}")
        with open(cut, "wb") as f:
            f.write(whole[:cut_at])
        with pytest.raises(IOError, match="truncated"):
            list(ttf.read_records(cut))
    bad = bytearray(whole)
    bad[14] ^= 1                            # a payload byte of record 1
    (tmp_path / "bad").write_bytes(bytes(bad))
    with pytest.raises(IOError, match="crc"):
        list(ttf.read_records(str(tmp_path / "bad"), verify=True))


def test_record_offsets_random_access(tmp_path):
    from wide_deep_tpu.features import tfrecord as jtf
    from wide_deep_tpu_torch.features import tfrecord as ttf
    payloads = [b"a" * 5, b"bb" * 9, b"c"]
    path = str(tmp_path / "r.tfrecords")
    ttf.write_records(path, iter(payloads))
    offs = ttf.record_offsets(path)
    assert offs == jtf.record_offsets(path) and len(offs) == 3
    with open(path, "rb") as f:
        for k in (2, 0, 1):
            assert ttf.read_record_at(f, *offs[k]) == payloads[k]


def test_decode_and_preprocess_match_jax():
    """decode_raw_image (HWC and channels_first), preprocess_custom and
    preprocess_vgg (train and eval, _bilinear_resize) give JAX's arrays
    from generators seeded alike."""
    from wide_deep_tpu.features import image as jimg
    from wide_deep_tpu_torch.features import image as timg
    from wide_deep_tpu_torch.features import tfrecord as ttf
    payload = next(ttf.read_records(IMAGE_TFRECORDS))
    for cf in (False, True):
        img = timg.decode_raw_image(payload, 224, 224, 3, cf)
        np.testing.assert_array_equal(
            img, jimg.decode_raw_image(payload, 224, 224, 3, cf))
        assert img.dtype == np.float32 and img.shape == (224, 224, 3)
    img = timg.decode_raw_image(payload)
    small = img[::7, ::5]                      # 32 x 45: non-square resize
    for fn in ("preprocess_custom", "preprocess_vgg"):
        for training in (True, False):
            for seed in range(3):
                src = small if fn == "preprocess_vgg" else img
                got = getattr(timg, fn)(src, np.random.default_rng(seed),
                                        training)
                want = getattr(jimg, fn)(src, np.random.default_rng(seed),
                                         training)
                np.testing.assert_array_equal(got, want)
    assert timg.preprocess_vgg(small, np.random.default_rng(0),
                               False).shape == (224, 224, 3)
    np.testing.assert_array_equal(timg.VGG_MEANS, jimg.VGG_MEANS)


@pytest.mark.parametrize("mode,preprocess", [("eval", None),
                                             ("train", "custom")])
def test_image_dataset_batches_as_jax(mode, preprocess):
    """24 records at batch 10: 3 batches, the last padded with zeros; the
    same arrays as JAX's (train mode shuffles and augments alike)."""
    from wide_deep_tpu.features.image import ImageDataset as J
    from wide_deep_tpu_torch.features.image import ImageDataset as T
    kw = dict(batch_size=10, preprocess=preprocess, shuffle_buffer=8,
              seed=5)
    got = list(T(IMAGE_TFRECORDS, mode, **kw))
    want = list(J(IMAGE_TFRECORDS, mode, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (10, 224, 224, 3)
        np.testing.assert_array_equal(g, w)
    assert not got[2][4:].any()
    with pytest.raises(ValueError, match="preprocess"):
        T(IMAGE_TFRECORDS, mode, batch_size=2, preprocess="bad")


def _index_images(tmp_path, n_imgs=6):
    """A TFRecord of 4 x 4 x 3 images whose every byte is its index."""
    from wide_deep_tpu_torch.features import tfrecord as ttf
    path = str(tmp_path / "imgs.tfrecords")
    ttf.write_records(path, iter(
        ttf.serialize_example({"image": [bytes([k]) * 48], "label": [k]})
        for k in range(n_imgs)))
    return path


def test_image_csv_dataset_pairs_by_index_when_shuffled(small_conf_dir,
                                                         tmp_path):
    """Row k gets image k % 6 in every batch of two shuffled epochs (the
    second reshuffles); padding rows stay zero."""
    from wide_deep_tpu_torch.features.image import ImageCsvDataset
    from wide_deep_tpu_torch.features.pipeline import CsvDataset
    plan = _port_plan(small_conf_dir)
    img_file = _index_images(tmp_path)
    ds = ImageCsvDataset(plan, UNIT_FIXTURE, img_file, "train", 4,
                         height=4, width=4, channels=3, seed=7)
    orders = []
    for epoch in range(2):
        mirror = CsvDataset(plan, UNIT_FIXTURE, "train", 4, seed=7)
        mirror._epoch = epoch
        got = list(ds)
        want = list(mirror.iter_with_indices())
        assert len(got) == len(want) > 1
        order = []
        for batch, (_, idxs) in zip(got, want):
            order.append(tuple(idxs))
            assert batch["image"].shape == (4, 4, 4, 3)
            for j, idx in enumerate(idxs):
                expect = 0.0 if idx < 0 else float(idx % 6)
                assert (batch["image"][j] == expect).all(), (epoch, j, idx)
        orders.append(order)
    assert orders[0] != orders[1]


def test_image_csv_dataset_keeps_images_under_sharding(small_conf_dir,
                                                       tmp_path):
    from wide_deep_tpu_torch.features.image import ImageCsvDataset
    from wide_deep_tpu_torch.features.pipeline import CsvDataset
    plan = _port_plan(small_conf_dir)
    img_file = _index_images(tmp_path)
    ds = ImageCsvDataset(plan, UNIT_FIXTURE, img_file, "eval", 4,
                         height=4, width=4, channels=3, num_shards=2,
                         shard_index=1)
    mirror = CsvDataset(plan, UNIT_FIXTURE, "eval", 4, num_shards=2,
                        shard_index=1)
    n = 0
    for batch, (_, idxs) in zip(ds, mirror.iter_with_indices()):
        for j, idx in enumerate(idxs):
            expect = 0.0 if idx < 0 else float(idx % 6)
            assert (batch["image"][j] == expect).all()
        assert all(i % 2 == 1 for i in idxs if i >= 0)
        n += 1
    assert n > 0


def test_image_csv_dataset_augments_as_jax(small_conf_dir, small_plan):
    """With ``preprocess='vgg'`` each row's image is the one JAX's dataset
    makes for that row index: record ``idx % 24`` augmented from the
    generator seeded with (seed, epoch, idx)."""
    from wide_deep_tpu.features.image import ImageCsvDataset as J
    from wide_deep_tpu_torch.features.image import ImageCsvDataset
    from wide_deep_tpu_torch.features.pipeline import CsvDataset
    plan = _port_plan(small_conf_dir)
    ds = ImageCsvDataset(plan, UNIT_FIXTURE, IMAGE_TFRECORDS, "train", 4,
                         preprocess="vgg", seed=3)
    jds = J(small_plan, UNIT_FIXTURE, IMAGE_TFRECORDS, "train", 4,
            preprocess="vgg", seed=3)
    assert ds.offsets == jds.offsets
    mirror = CsvDataset(plan, UNIT_FIXTURE, "train", 4, seed=3)
    with open(IMAGE_TFRECORDS, "rb") as f:
        for batch, (_, idxs) in zip(ds, mirror.iter_with_indices()):
            for j, idx in enumerate(idxs):
                if idx < 0:
                    assert not batch["image"][j].any()
                    continue
                rng = np.random.default_rng([3, 0, int(idx)])
                np.testing.assert_array_equal(
                    batch["image"][j], jds._image_at(int(idx), f, rng))


def test_create_record_rebuilds_the_committed_file(tmp_path, capsys):
    """``tools.create_record`` over data/image/train (24 PNGs) writes the
    committed train.tfrecords byte for byte, as the JAX package's tool
    does; an unreadable file is skipped with a line saying so."""
    import os
    import shutil
    import subprocess
    import sys

    from paths import REPO
    from wide_deep_tpu_torch.tools import create_record
    src = os.path.join(REPO, "data", "image", "train")
    out = str(tmp_path / "t.tfrecords")
    assert create_record.main(["--input_dir", src, "--output", out]) == 24
    whole = open(IMAGE_TFRECORDS, "rb").read()
    assert open(out, "rb").read() == whole
    jout = str(tmp_path / "j.tfrecords")
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "create_record.py"),
                    "--input_dir", src, "--output", jout], check=True,
                   capture_output=True, timeout=120)
    assert open(jout, "rb").read() == whole
    mixed = tmp_path / "mixed"
    shutil.copytree(src, mixed)
    (mixed / "zz_notes.txt").write_text("not an image")
    capsys.readouterr()
    assert create_record.main(["--input_dir", str(mixed), "--output",
                               str(tmp_path / "m.tfrecords"), "--height",
                               "8", "--width", "6"]) == 24
    assert "skipping unreadable zz_notes.txt" in capsys.readouterr().out
    from wide_deep_tpu_torch.features import image, tfrecord
    first = next(tfrecord.read_records(str(tmp_path / "m.tfrecords")))
    assert image.decode_raw_image(first, 8, 6, 3).shape == (8, 6, 3)
