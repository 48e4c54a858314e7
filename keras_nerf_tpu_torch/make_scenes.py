"""Regenerate the benchmark scenes with their exact parameters (port of
``scripts/make_scenes.py``).

    python -m keras_nerf_tpu_torch.make_scenes            # all three scenes
    python -m keras_nerf_tpu_torch.make_scenes spheres    # data/synthetic_128

The scenes are written under the repository root by the port's
:func:`~keras_nerf_tpu_torch.data.synthetic.write_synthetic_scene`, whose
PNGs are the JAX package's writer's byte for byte (a fixed seed, a NumPy
ray tracer). Each scene's line ends with two digests of its directory
(:func:`scene_digest`): of the files' bytes, and of their content (the
decoded pixels and the parsed JSON), which a PNG encoder of another
version leaves as it is.
"""

import hashlib
import json
import os
import sys

import numpy as np

from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (out_dir, kwargs). These parameters are LOAD-BEARING: changing
# any of them silently invalidates every committed PSNR in docs/QUALITY.md.
SCENES = {
    # The easy Lambertian-spheres quality scene (all 128^2 headline runs).
    "spheres": ("data/synthetic_128", dict(
        image_wh=128, n_train=100, n_val=8, n_test=8, supersample=4)),
    # The adversarial thin-geometry scene (hard-scene A/Bs + frontier).
    "hard": ("data/hard_128", dict(
        image_wh=128, n_train=100, n_val=8, n_test=8, supersample=4,
        scene="hard")),
    # The 2x-scale spheres scene (the --occupancy_aabb demo; train with
    # --near 4 --far 12, bake with --occupancy_aabb -4 -4 -4 4 4 4).
    "scaled2": ("data/scaled2_64", dict(
        image_wh=64, n_train=50, n_val=8, n_test=8, supersample=4,
        scale=2.0)),
}


def scene_digest(path: str) -> dict:
    """``{"files", "bytes_sha256", "content_sha256"}`` of a scene
    directory: the SHA-256 over every file's relative path and bytes, in
    sorted order, and over the same paths with each PNG's decoded pixels
    (shape and values) and each JSON file's parsed, key-sorted value."""
    from PIL import Image

    files = sorted(os.path.relpath(os.path.join(root, name), path)
                   for root, _, names in os.walk(path) for name in names)
    raw, content = hashlib.sha256(), hashlib.sha256()
    for rel in files:
        full = os.path.join(path, rel)
        with open(full, "rb") as f:
            data = f.read()
        for h in (raw, content):
            h.update(rel.encode() + b"\0")
        raw.update(data)
        if rel.endswith(".png"):
            with Image.open(full) as img:
                pixels = np.asarray(img.convert("RGBA"))
            content.update(repr(pixels.shape).encode() + pixels.tobytes())
        elif rel.endswith(".json"):
            content.update(json.dumps(json.loads(data),
                                      sort_keys=True).encode())
        else:
            content.update(data)
    return {"files": len(files), "bytes_sha256": raw.hexdigest(),
            "content_sha256": content.hexdigest()}


def main(argv=None):
    wanted = (sys.argv[1:] if argv is None else list(argv)) or list(SCENES)
    unknown = [w for w in wanted if w not in SCENES]
    if unknown:
        raise SystemExit(f"unknown scene(s) {unknown}; "
                         f"choose from {sorted(SCENES)}")
    for name in wanted:
        rel, kwargs = SCENES[name]
        out = os.path.join(_REPO, rel)
        if os.path.exists(os.path.join(out, "transforms_train.json")):
            print(f"{name}: {rel} already exists, skipping")
        else:
            write_synthetic_scene(out, **kwargs)
            print(f"{name}: wrote {rel} {kwargs}")
        print(f"{name}: digest {json.dumps(scene_digest(out))}")


if __name__ == "__main__":
    main()
