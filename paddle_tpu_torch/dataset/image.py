"""paddle_tpu_torch.dataset.image — image preprocessing.

Counterpart of ``paddle_tpu/dataset/image.py`` (Paddle's
``python/paddle/dataset/image.py``: resize_short, center_crop,
random_crop, left_right_flip, to_chw, simple_transform,
load_and_transform), the same pure-numpy code (nearest-neighbour resize,
no cv2) and so the same pixels. Images are HWC uint8 or float arrays."""
from __future__ import annotations

import numpy as np


def resize_short(im, size):
    """Resize so the SHORT side == size, keeping aspect (reference:
    image.py:197)."""
    h, w = im.shape[:2]
    if h < w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    return resize_exact(im, nh, nw)


def to_chw(im, order=(2, 0, 1)):
    """reference: image.py:225."""
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    """reference: image.py:249."""
    h, w = im.shape[:2]
    y0 = max((h - size) // 2, 0)
    x0 = max((w - size) // 2, 0)
    return im[y0:y0 + size, x0:x0 + size]


def random_crop(im, size, is_color=True, rng=None):
    """reference: image.py:277."""
    rng = rng or np.random
    h, w = im.shape[:2]
    y0 = rng.randint(0, max(h - size, 0) + 1)
    x0 = rng.randint(0, max(w - size, 0) + 1)
    return im[y0:y0 + size, x0:x0 + size]


def left_right_flip(im, is_color=True):
    """reference: image.py:305."""
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None, rng=None):
    """reference: image.py:327 — resize_short → crop (random+flip when
    training, center otherwise) → CHW float → mean-subtract."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if (rng or np.random).randint(2):
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    if im.ndim == 2:
        im = im[:, :, None]
    im = to_chw(im).astype("float32")
    if mean is not None:
        mean = np.asarray(mean, "float32")
        im -= mean.reshape(-1, 1, 1) if mean.ndim == 1 else mean
    return im


def load_image(path, is_color=True):
    """reference: image.py:167 — without cv2 only .npy payloads load."""
    if path.endswith(".npy"):
        return np.load(path)
    raise NotImplementedError(
        "store images as .npy (cv2 is not a dependency)")


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    """reference: image.py:383."""
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def resize_exact(im, h, w):
    """Nearest-neighbor resize to exactly (h, w) — the shared separable
    index arithmetic (used by resize_short and hapi transforms)."""
    im = np.asarray(im)
    ys = (np.arange(h) * (im.shape[0] / h)).astype(int).clip(0,
                                                             im.shape[0] - 1)
    xs = (np.arange(w) * (im.shape[1] / w)).astype(int).clip(0,
                                                             im.shape[1] - 1)
    return im[ys][:, xs]


def load_image_bytes(bytes, is_color=True):
    """reference image.py:load_image_bytes — decode an image from a
    bytes buffer. The reference decodes via cv2; here PNG/raw-npy
    buffers decode without native deps (JPEG needs cv2 or PIL, which the
    package does not depend on: decode in the host pipeline)."""
    import io
    try:
        with io.BytesIO(bytes) as bio:
            im = np.load(bio, allow_pickle=False)
        if not is_color and im.ndim == 3:
            im = im.mean(axis=2).astype(im.dtype)
        return im
    except Exception:
        pass
    try:
        import matplotlib.image as mpimg  # optional
        import io as _io
        im = mpimg.imread(_io.BytesIO(bytes), format=None)
        if im.dtype != np.uint8:
            im = (im * 255).astype("u1")
        if not is_color and im.ndim == 3:
            im = im.mean(axis=2).astype("u1")
        return im
    except Exception as e:
        raise ValueError(
            "load_image_bytes: buffer is neither .npy nor a format "
            f"matplotlib can decode ({type(e).__name__}); decode "
            "JPEGs in the host data pipeline") from e


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """reference image.py:batch_images_from_tar — read images from a
    tar, pickle them into batch files of (data, label) lists, write a
    batch manifest; returns the manifest path."""
    import os
    import pickle
    import tarfile

    out_path = f"{data_file}_{dataset_name}_batch"
    meta_file = os.path.join(out_path, "batch_names.txt")
    if os.path.exists(meta_file):
        return meta_file
    os.makedirs(out_path, exist_ok=True)
    tf = tarfile.open(data_file)
    mems = tf.getmembers()
    data, labels, names, file_id = [], [], [], 0
    for mem in mems:
        if mem.name not in img2label:
            continue
        data.append(tf.extractfile(mem).read())
        labels.append(img2label[mem.name])
        if len(data) == num_per_batch:
            output = {"label": labels, "data": data}
            name = os.path.join(out_path, f"batch_{file_id}")
            with open(name, "wb") as f:
                pickle.dump(output, f, protocol=2)
            names.append(os.path.basename(name))
            file_id += 1
            data, labels = [], []
    if data:
        output = {"label": labels, "data": data}
        name = os.path.join(out_path, f"batch_{file_id}")
        with open(name, "wb") as f:
            pickle.dump(output, f, protocol=2)
        names.append(os.path.basename(name))
    with open(meta_file, "w") as f:
        f.write("\n".join(names) + "\n")
    return meta_file
