"""Image input pipeline: TFRecord raw-pixel records + host preprocessing
(the port's copy of the JAX package's ``features/image.py``).

Replaces the reference's ``_ImageDataSet`` (its python/lib/dataset.py:
198-290) and its two preprocessing paths (utils/image_preprocessing.py,
utils/vgg_preprocessing.py) with host-side numpy transforms feeding
fixed-shape [B, H, W, C] float32 batches, merged into the CSV batch under
the ``image`` key (dataset.py:293-310).  Images pair with rows by the row's
original index (``ImageCsvDataset``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from wide_deep_tpu_torch.features import fs, tfrecord
from wide_deep_tpu_torch.features.pipeline import Batch, CsvDataset
from wide_deep_tpu_torch.features.plan import FeaturePlan

# ILSVRC channel means, the standard VGG preprocessing constants
VGG_MEANS = np.array([123.68, 116.78, 103.94], dtype=np.float32)


def decode_raw_image(payload: bytes, height: int = 224, width: int = 224,
                     channels: int = 3, channels_first: bool = False
                     ) -> np.ndarray:
    """Raw uint8 Example -> [H, W, C] float32.

    create_record.py writes PIL ``tobytes`` (HWC); dataset.py re-reads the
    same bytes as CHW + transpose — a reference inconsistency.  We decode as
    written (HWC) by default; set ``channels_first`` for CHW-written data.
    """
    ex = tfrecord.parse_example(payload)
    raw = np.frombuffer(ex["image"][0], dtype=np.uint8)
    if channels_first:
        img = raw.reshape(channels, height, width).transpose(1, 2, 0)
    else:
        img = raw.reshape(height, width, channels)
    return img.astype(np.float32)


# ------------------------------------------------------------- preprocessing
def preprocess_custom(image: np.ndarray, rng: np.random.Generator,
                      is_training: bool) -> np.ndarray:
    """Crop-pad / random-crop / flip + per-image standardization
    (utils/image_preprocessing.py:12-24 semantics)."""
    h, w, _ = image.shape
    if is_training:
        padded = np.pad(image, ((4, 4), (4, 4), (0, 0)), mode="constant")
        top = int(rng.integers(0, 9))
        left = int(rng.integers(0, 9))
        image = padded[top:top + h, left:left + w]
        if rng.random() < 0.5:
            image = image[:, ::-1]
    mean = image.mean()
    std = max(float(image.std()), 1.0 / np.sqrt(image.size))
    return ((image - mean) / std).astype(np.float32)


def preprocess_vgg(image: np.ndarray, rng: np.random.Generator,
                   is_training: bool, output_height: int = 224,
                   output_width: int = 224) -> np.ndarray:
    """Aspect-preserving resize + (random|central) crop + mean subtraction
    (utils/vgg_preprocessing.py:243-314 semantics, numpy edition)."""
    h, w, _ = image.shape
    if is_training:
        resize_side = int(rng.integers(256, 513))
    else:
        resize_side = 256
    scale = resize_side / min(h, w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    image = _bilinear_resize(image, new_h, new_w)
    if is_training:
        top = int(rng.integers(0, new_h - output_height + 1))
        left = int(rng.integers(0, new_w - output_width + 1))
        image = image[top:top + output_height, left:left + output_width]
        if rng.random() < 0.5:
            image = image[:, ::-1]
    else:
        top = (new_h - output_height) // 2
        left = (new_w - output_width) // 2
        image = image[top:top + output_height, left:left + output_width]
    return (image - VGG_MEANS).astype(np.float32)


def _bilinear_resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w, c = image.shape
    if (h, w) == (out_h, out_w):
        return image
    ys = np.linspace(0, h - 1, out_h)
    xs = np.linspace(0, w - 1, out_w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = image[y0][:, x0]
    b = image[y0][:, x1]
    cc = image[y1][:, x0]
    d = image[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + cc * wy * (1 - wx) + d * wy * wx).astype(np.float32)


# ------------------------------------------------------------------ datasets
class ImageDataset:
    """TFRecord image stream -> [B, H, W, C] float32 arrays."""

    def __init__(self, data_file: str, mode: str, batch_size: int,
                 height: int = 224, width: int = 224, channels: int = 3,
                 preprocess: Optional[str] = None,
                 shuffle_buffer: int = 10000, seed: int = 123,
                 channels_first: bool = False):
        if preprocess not in (None, "custom", "vgg"):
            raise ValueError(f"bad preprocess {preprocess}")
        self.data_file = data_file
        self.mode = mode
        self.batch_size = batch_size
        self.h, self.w, self.c = height, width, channels
        self.preprocess = preprocess
        self.shuffle_buffer = shuffle_buffer if mode == "train" else 0
        self.seed = seed
        self.channels_first = channels_first

    def _images(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        payloads = tfrecord.read_records(self.data_file)
        if self.shuffle_buffer > 1:
            srng = np.random.default_rng(self.seed)
            buf: List[bytes] = []
            def shuffled():
                for p in payloads:
                    buf.append(p)
                    if len(buf) >= self.shuffle_buffer:
                        j = srng.integers(len(buf))
                        buf[j], buf[-1] = buf[-1], buf[j]
                        yield buf.pop()
                for j in srng.permutation(len(buf)):
                    yield buf[j]
            source = shuffled()
        else:
            source = payloads
        training = self.mode == "train"
        for payload in source:
            img = decode_raw_image(payload, self.h, self.w, self.c,
                                   self.channels_first)
            if self.preprocess == "custom":
                img = preprocess_custom(img, rng, training)
            elif self.preprocess == "vgg":
                img = preprocess_vgg(img, rng, training, self.h, self.w)
            yield img

    def __iter__(self) -> Iterator[np.ndarray]:
        chunk: List[np.ndarray] = []
        for img in self._images():
            chunk.append(img)
            if len(chunk) == self.batch_size:
                yield np.stack(chunk)
                chunk = []
        if chunk:
            out = np.zeros((self.batch_size, self.h, self.w, self.c),
                           np.float32)
            out[:len(chunk)] = np.stack(chunk)
            yield out


class ImageCsvDataset:
    """CSV + image streams composed into one batch dict (module input_fn
    parity, dataset.py:293-310).

    Pairing is BY ROW INDEX, not by praying two independently-shuffled
    streams stay in step: the reference aligned csv row k with image
    record k through matching tf.data shuffle seeds (dataset.py:270-274)
    — a contract that silently breaks under sharding, malformed-row
    skipping, epoch reseeding, or any shuffle-algorithm difference.
    Here the csv dataset reports each batch row's ORIGINAL file index
    (CsvDataset.iter_with_indices) and the image for row k is record
    ``k % n_records``, random-accessed through a one-pass offset index
    (features/tfrecord.record_offsets) — exact under every row
    reordering, and the shorter-image-set cycling is exact modular
    arithmetic instead of stream restarts.  Train-time augmentation is
    seeded per (seed, epoch, row index), so it stays deterministic AND
    redraws across epochs."""

    def __init__(self, plan: FeaturePlan, csv_file: str, img_file: str,
                 mode: str, batch_size: int,
                 height: int = 224, width: int = 224, channels: int = 3,
                 preprocess: Optional[str] = None,
                 channels_first: bool = False, **csv_kwargs):
        if preprocess not in (None, "custom", "vgg"):
            raise ValueError(f"bad preprocess {preprocess}")
        self.csv = CsvDataset(plan, csv_file, mode, batch_size, **csv_kwargs)
        self.img_file = img_file
        self.mode = mode
        self.batch_size = batch_size
        self.h, self.w, self.c = height, width, channels
        self.preprocess = preprocess
        self.channels_first = channels_first
        self.seed = csv_kwargs.get("seed", 123)
        self.offsets = tfrecord.record_offsets(img_file)
        if not self.offsets:
            raise ValueError(f"no image records in {img_file}")
        self._epoch = 0

    def _image_at(self, row_idx: int, f, rng) -> np.ndarray:
        off, length = self.offsets[row_idx % len(self.offsets)]
        payload = tfrecord.read_record_at(f, off, length)
        img = decode_raw_image(payload, self.h, self.w, self.c,
                               self.channels_first)
        training = self.mode == "train"
        if self.preprocess == "custom":
            img = preprocess_custom(img, rng, training)
        elif self.preprocess == "vgg":
            img = preprocess_vgg(img, rng, training, self.h, self.w)
        return img

    def __iter__(self) -> Iterator[Batch]:
        epoch = self._epoch
        self._epoch += 1
        with fs.open_bytes(self.img_file) as f:
            for batch, idxs in self.csv.iter_with_indices():
                images = np.zeros((self.batch_size, self.h, self.w, self.c),
                                  np.float32)
                for j, idx in enumerate(idxs):
                    if idx < 0:
                        continue  # padding row of a partial final batch
                    rng = np.random.default_rng(
                        [self.seed, epoch, int(idx)])
                    images[j] = self._image_at(int(idx), f, rng)
                batch["image"] = images
                yield batch
