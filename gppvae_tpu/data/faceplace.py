"""Face-view dataset: FacePlace HDF5 loader + synthetic-face fallback.

Reference counterpart: pysrc/faceplace/data_parser.py (SURVEY.md §2.1) —
loads the FacePlace face dataset as a people × poses grid. The real dataset
is license-gated, so this module accepts any HDF5 laid out as below and also
ships a procedural face generator with the same grid contract so the
face-view GPPVAE config (BASELINE.json:10) is runnable end-to-end anywhere.

HDF5 layout accepted by `build_faceplace("h5:<path>")` — datasets:
    images      (N, H, W, 3) uint8 or float, or (N, 3, H, W)
    object_ids  (N,) int      (aliases: 'person', 'subject', 'Did')
    view_ids    (N,) int      (aliases: 'pose', 'view', 'Wid')
Rows must cover a complete object×view grid (missing cells are dropped to
the largest complete sub-grid).
"""

from __future__ import annotations

import numpy as np

from gppvae_tpu.data.dataset import GridDataset, make_grid_split

_OBJ_KEYS = ("object_ids", "person", "subject", "Did")
_VIEW_KEYS = ("view_ids", "pose", "view", "Wid")


def synthetic_faces(
    num_people: int, num_poses: int, hw: int = 64, seed: int = 0
) -> np.ndarray:
    """Procedural face grid: (P·Q, hw, hw, 3) float32, row n = d·Q + q.

    Identity controls geometry/color (head shape, skin tone, eye spacing,
    hair); pose q is a yaw angle in [-60°, 60°] that translates/squashes the
    features like a turning head. Smooth in both factors so an object×view
    product kernel fits it well.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, hw), np.linspace(-1, 1, hw), indexing="ij")
    yaws = np.linspace(-np.pi / 3, np.pi / 3, num_poses)
    out = np.zeros((num_people * num_poses, hw, hw, 3), dtype=np.float32)

    for d in range(num_people):
        head_w = rng.uniform(0.55, 0.72)
        head_h = rng.uniform(0.72, 0.9)
        skin = np.array([rng.uniform(0.55, 0.95), rng.uniform(0.45, 0.75),
                         rng.uniform(0.35, 0.62)], np.float32)
        hair = rng.uniform(0.05, 0.5, size=3).astype(np.float32)
        eye_y = rng.uniform(-0.28, -0.15)
        eye_dx = rng.uniform(0.2, 0.3)
        eye_r = rng.uniform(0.05, 0.085)
        mouth_y = rng.uniform(0.32, 0.45)
        mouth_w = rng.uniform(0.18, 0.3)
        nose_len = rng.uniform(0.12, 0.22)
        brow = rng.uniform(0.04, 0.09)

        for q, yaw in enumerate(yaws):
            s = np.sin(yaw)
            c = max(np.cos(yaw), 0.35)
            img = np.zeros((hw, hw, 3), dtype=np.float32)
            img[:] = 0.12 + 0.05 * yy[..., None]  # background gradient

            hx = 0.15 * s  # head center shifts with yaw
            head = ((xx - hx) / (head_w * c)) ** 2 + (yy / head_h) ** 2 < 1.0
            img[head] = skin

            hairline = head & (yy < eye_y - 0.22 + 0.06 * np.cos(3 * xx * np.pi))
            img[hairline] = hair

            fx = hx + 0.55 * s * head_w  # feature-plane shift
            for sgn in (-1.0, 1.0):
                ex = fx + sgn * eye_dx * c
                vis = (sgn * s) < 0.85  # far eye disappears in profile
                if vis:
                    eye = (xx - ex) ** 2 / (c**2) + (yy - eye_y) ** 2 < eye_r**2
                    img[eye & head] = np.array([0.95, 0.95, 0.95])
                    pupil = (xx - ex - 0.2 * eye_r * s) ** 2 / (c**2) + (
                        yy - eye_y
                    ) ** 2 < (0.45 * eye_r) ** 2
                    img[pupil & head] = np.array([0.08, 0.08, 0.1])
                    brows = (np.abs(yy - (eye_y - 1.8 * eye_r)) < brow / 2) & (
                        np.abs(xx - ex) < 1.6 * eye_r * c
                    )
                    img[brows & head] = hair
            nose = (np.abs(xx - fx - 0.02 * s) < 0.025) & (
                (yy > eye_y + 0.08) & (yy < eye_y + 0.08 + nose_len)
            )
            img[nose & head] = skin * 0.75
            mouth = (np.abs(yy - mouth_y) < 0.035) & (np.abs(xx - fx) < mouth_w * c)
            img[mouth & head] = np.array([0.6, 0.2, 0.25])

            out[d * num_poses + q] = np.clip(img, 0.0, 1.0)
    return out


def _load_h5(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    from gppvae_tpu.utils.deps import optional_import

    h5py = optional_import("h5py", "reading a FacePlace .h5 file")
    with h5py.File(path, "r") as f:
        def pick(keys):
            for k in keys:
                if k in f:
                    return np.asarray(f[k])
            raise KeyError(f"{path}: none of {keys} present (have {list(f)})")

        images = np.asarray(f["images"])
        obj = pick(_OBJ_KEYS).reshape(-1).astype(np.int32)
        view = pick(_VIEW_KEYS).reshape(-1).astype(np.int32)
    if images.ndim == 4 and images.shape[1] == 3 and images.shape[-1] != 3:
        images = images.transpose(0, 2, 3, 1)  # NCHW → NHWC
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    return images.astype(np.float32), obj, view


def build_faceplace(
    source: str = "synthetic",
    *,
    num_people: int = 64,
    num_poses: int = 9,
    image_size: int | None = None,
    heldout_per_object: int = 1,
    val_fraction: float = 0.05,
    seed: int = 0,
) -> GridDataset:
    """Build the face-view grid dataset ('synthetic' or 'h5:<path>').

    image_size: None = the source's native size (64 for synthetic; the
    file's own resolution for h5). An EXPLICIT size resizes h5 images by
    nearest-neighbor resampling — previously the parameter was silently
    dead code on the h5 branch, so a caller sizing a model for 64² could
    get a 128² pixel grid with no warning."""
    if source == "synthetic":
        images = synthetic_faces(
            num_people, num_poses, hw=image_size or 64, seed=seed
        )
        P, Q = num_people, num_poses
    elif source.startswith("h5:"):
        raw, obj, view = _load_h5(source[3:])
        if image_size is not None and raw.shape[1:3] != (image_size, image_size):
            # nearest-neighbor resample to the requested square size — no
            # external deps; the decoder needs H=W divisible by 2^depth
            ri = np.minimum(
                np.arange(image_size) * raw.shape[1] // image_size,
                raw.shape[1] - 1,
            )
            ci = np.minimum(
                np.arange(image_size) * raw.shape[2] // image_size,
                raw.shape[2] - 1,
            )
            raw = raw[:, ri][:, :, ci]
        # re-index to dense ids and keep the complete sub-grid
        uo, obj = np.unique(obj, return_inverse=True)
        uv, view = np.unique(view, return_inverse=True)
        P, Q = len(uo), len(uv)
        grid = -np.ones((P, Q), dtype=np.int64)
        grid[obj, view] = np.arange(len(raw))
        # largest complete sub-grid (greedy): drop the worst-covered view
        # column while no object row is complete, then keep complete rows
        while not (grid >= 0).all(axis=1).any():
            if grid.shape[1] <= 1:
                raise ValueError("no complete object×view sub-grid exists")
            worst = int(np.argmax((grid < 0).sum(axis=0)))
            grid = np.delete(grid, worst, axis=1)
        keep = (grid >= 0).all(axis=1)
        grid = grid[keep]
        P, Q = grid.shape
        images = raw[grid.reshape(-1)]
    else:
        raise ValueError(f"unknown source {source!r}; want 'synthetic' or 'h5:<path>'")

    object_ids = np.repeat(np.arange(P, dtype=np.int32), Q)
    view_ids = np.tile(np.arange(Q, dtype=np.int32), P)
    train_idx, val_idx, heldout_idx = make_grid_split(
        P, Q, heldout_per_object=heldout_per_object,
        val_fraction=val_fraction, seed=seed,
    )
    return GridDataset(
        images=images,
        object_ids=object_ids,
        view_ids=view_ids,
        view_aux=np.linspace(-1.0, 1.0, Q, dtype=np.float32)[:, None],
        train_idx=train_idx,
        val_idx=val_idx,
        heldout_idx=heldout_idx,
        name="faceplace-synthetic" if source == "synthetic" else "faceplace-h5",
        periodic_views=False,  # pose/yaw is a linear axis, not a circle
    )
