"""Procedural synthetic shapes (``spnerf_tpu/data/synthetic_draw.py``),
numpy only.

Nine drawing primitives, each returning a grayscale uint8 image and the
ground-truth corners as an (N, 2) float32 array in (y, x) order, plus the
cloudy background they are drawn on. The numpy ``Generator`` draws are
the reference's, in its order; cv2's rasteriser, box blur, perspective
transforms and random fill are the port's own byte-equal copies
(``data/cv_draw.py``, ``data/cv_filter.py``, ``eval/cv_rng.py``), so a
sample here is the reference's byte for byte.

The background's and the noise primitive's fills draw from OpenCV's
generator, ``cv_rng`` (default: the calling thread's, as cv2's ``randu``
does), so they depend on how many fills came before them in that
thread.
"""

from __future__ import annotations

import math

import numpy as np

from spnerf_tpu_torch.data import cv_draw
from spnerf_tpu_torch.data.cv_filter import blur_u8
from spnerf_tpu_torch.eval.cv_rng import randu

PRIMITIVES = (
    "draw_lines",
    "draw_polygon",
    "draw_multiple_polygons",
    "draw_ellipses",
    "draw_star",
    "draw_checkerboard",
    "draw_stripes",
    "draw_cube",
    "gaussian_noise",
)


def _random_color(rng, background=None):
    c = int(rng.integers(0, 256))
    if background is not None:
        # keep contrast against the mean background
        while abs(c - background) < 30:
            c = int(rng.integers(0, 256))
    return c


def generate_background(
    size=(960, 1280),
    rng=None,
    nb_blobs=100,
    min_rad_ratio=0.02,
    max_rad_ratio=0.031,
    min_kernel_size=150,
    max_kernel_size=500,
    cv_rng=None,
):
    """Cloudy background: random dim base, random blobs, heavy blur."""
    rng = rng or np.random.default_rng()
    img = np.zeros(size, np.uint8)
    dim = max(size)
    base = int(rng.integers(0, 60))
    randu(img, base, base + 40, cv_rng)
    img = blur_u8(img, int(dim * 0.1))
    centers = np.stack(
        [rng.integers(0, size[1], nb_blobs), rng.integers(0, size[0], nb_blobs)],
        axis=-1,
    )
    for i in range(nb_blobs):
        col = _random_color(rng)
        rad = int(rng.uniform(min_rad_ratio, max_rad_ratio) * dim)
        cv_draw.circle(img, (int(centers[i][0]), int(centers[i][1])), rad,
                       col)
    kernel = int(rng.integers(min_kernel_size, max_kernel_size))
    return blur_u8(img, kernel)


def _keep_inside(points, shape):
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    H, W = shape
    m = (pts[:, 0] >= 0) & (pts[:, 0] < H) & (pts[:, 1] >= 0) & (pts[:, 1] < W)
    return pts[m]


def _ccw_sort(points_xy):
    center = points_xy.mean(0)
    ang = np.arctan2(points_xy[:, 1] - center[1], points_xy[:, 0] - center[0])
    return points_xy[np.argsort(ang)]


def draw_lines(img, rng, nb_lines=10):
    """Random segments; corners are the endpoints."""
    H, W = img.shape
    n = int(rng.integers(1, nb_lines))
    segments = []
    points = []
    mean = int(img.mean())
    for _ in range(n):
        x1, x2 = rng.integers(0, W, 2)
        y1, y2 = rng.integers(0, H, 2)
        # reject segments that overlap existing ones (cheap bbox test)
        new = np.array([min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)])
        if any(
            not (new[2] < s[0] or s[2] < new[0] or new[3] < s[1] or s[3] < new[1])
            for s in segments
        ):
            continue
        segments.append(new)
        col = _random_color(rng, mean)
        thickness = int(rng.integers(max(1, min(H, W) // 80), max(2, min(H, W) // 20)))
        cv_draw.line(img, (int(x1), int(y1)), (int(x2), int(y2)), col,
                     thickness)
        points += [(y1, x1), (y2, x2)]
    return img, _keep_inside(points, img.shape)


def _random_polygon_xy(rng, shape, max_sides=8, rad_ratio=0.25):
    H, W = shape
    rad = max(int(min(H, W) * rad_ratio), 10)
    x = int(rng.integers(rad, W - rad))
    y = int(rng.integers(rad, H - rad))
    n = int(rng.integers(3, max_sides + 1))
    slices = np.linspace(0, 2 * math.pi, n + 1)[:-1]
    angles = slices + rng.uniform(0, 2 * math.pi / n, n)
    radii = rng.uniform(0.3 * rad, rad, n)
    pts = np.stack(
        [x + radii * np.cos(angles), y + radii * np.sin(angles)], axis=-1
    )
    # drop near-collinear / too-close vertices so every vertex is a corner
    keep = []
    for i in range(len(pts)):
        a = pts[(i - 1) % len(pts)]
        b = pts[i]
        c = pts[(i + 1) % len(pts)]
        v1, v2 = a - b, c - b
        norm = np.linalg.norm(v1) * np.linalg.norm(v2)
        if norm < 1e-6:
            continue
        cosang = abs(np.dot(v1, v2) / norm)
        if cosang < 0.97 and np.linalg.norm(v1) > 0.1 * rad:
            keep.append(b)
    if len(keep) < 3:
        return None
    return _ccw_sort(np.array(keep, np.float32))


def draw_polygon(img, rng, max_sides=8):
    pts = None
    for _ in range(10):
        pts = _random_polygon_xy(rng, img.shape, max_sides)
        if pts is not None:
            break
    if pts is None:
        return img, np.zeros((0, 2), np.float32)
    col = _random_color(rng, int(img.mean()))
    cv_draw.fill_poly(img, [pts.astype(np.int32)], col)
    points = pts[:, ::-1]  # (x, y) -> (y, x)
    return img, _keep_inside(points, img.shape)


def draw_multiple_polygons(img, rng, max_polygons=6, kernel_boundaries=(50, 100)):
    H, W = img.shape
    mean = int(img.mean())
    placed = []  # (cx, cy, rad)
    points = []
    for _ in range(int(rng.integers(2, max_polygons + 1))):
        pts = _random_polygon_xy(rng, img.shape, max_sides=6, rad_ratio=0.15)
        if pts is None:
            continue
        center = pts.mean(0)
        rad = np.max(np.linalg.norm(pts - center, axis=1))
        if any(
            np.linalg.norm(center - np.array([cx, cy])) < rad + r
            for cx, cy, r in placed
        ):
            continue
        placed.append((center[0], center[1], rad))
        col = _random_color(rng, mean)
        cv_draw.fill_poly(img, [pts.astype(np.int32)], col)
        points += [(p[1], p[0]) for p in pts]
    return img, _keep_inside(points, img.shape)


def draw_ellipses(img, rng, nb_ellipses=20):
    """Ellipses have no corners -> empty point set."""
    H, W = img.shape
    placed = []
    mean = int(img.mean())
    for _ in range(nb_ellipses):
        ax = int(max(rng.integers(min(H, W) // 20, min(H, W) // 5), 5))
        ay = int(max(rng.integers(min(H, W) // 20, min(H, W) // 5), 5))
        rad = max(ax, ay)
        x = int(rng.integers(rad, W - rad))
        y = int(rng.integers(rad, H - rad))
        if any(np.hypot(x - px, y - py) < rad + pr for px, py, pr in placed):
            continue
        placed.append((x, y, rad))
        angle = rng.uniform(0, 180)
        col = _random_color(rng, mean)
        cv_draw.ellipse(img, (x, y), (ax, ay), angle, col)
    return img, np.zeros((0, 2), np.float32)


def draw_star(img, rng, nb_branches=6):
    H, W = img.shape
    num = int(rng.integers(3, nb_branches + 1))
    rad = max(int(min(H, W) * 0.3), 10)
    x = int(rng.integers(rad, W - rad))
    y = int(rng.integers(rad, H - rad))
    angles = rng.uniform(0, 2 * math.pi, num)
    radii = rng.uniform(0.3 * rad, rad, num)
    ends = np.stack([x + radii * np.cos(angles), y + radii * np.sin(angles)], -1)
    mean = int(img.mean())
    thickness = int(rng.integers(max(1, min(H, W) // 80), max(2, min(H, W) // 25)))
    for ex, ey in ends:
        col = _random_color(rng, mean)
        cv_draw.line(img, (x, y), (int(ex), int(ey)), col, thickness)
    points = [(y, x)] + [(ey, ex) for ex, ey in ends]
    return img, _keep_inside(points, img.shape)


def _random_homography_for_grid(rng, shape, strength=0.1):
    H, W = shape
    src = np.array([[0, 0], [W, 0], [W, H], [0, H]], np.float32)
    jitter = rng.uniform(-strength, strength, (4, 2)).astype(np.float32)
    dst = src + jitter * np.array([W, H], np.float32)
    return cv_draw.get_perspective_transform(src, dst)


def draw_checkerboard(img, rng, max_rows=7, max_cols=7, transform_params=(0.05, 0.15)):
    H, W = img.shape
    rows = int(rng.integers(3, max_rows + 1))
    cols = int(rng.integers(3, max_cols + 1))
    ys = np.linspace(0, H - 1, rows + 1)
    xs = np.linspace(0, W - 1, cols + 1)
    M = _random_homography_for_grid(rng, (H, W), strength=float(rng.uniform(*transform_params)))
    board = np.zeros_like(img)
    for i in range(rows):
        for j in range(cols):
            col = _random_color(rng)
            quad = np.array(
                [[xs[j], ys[i]], [xs[j + 1], ys[i]], [xs[j + 1], ys[i + 1]], [xs[j], ys[i + 1]]],
                np.float32,
            )
            warped = cv_draw.perspective_transform(quad[None], M)[0]
            cv_draw.fill_poly(board, [warped.astype(np.int32)], col)
    # overlay board on background where board drawn
    mask = np.zeros_like(img)
    corners_xy = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.float32)
    full = cv_draw.perspective_transform(
        np.array([[[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]]], np.float32), M
    )[0]
    cv_draw.fill_poly(mask, [full.astype(np.int32)], 255)
    img[mask > 0] = board[mask > 0]
    warped_corners = cv_draw.perspective_transform(corners_xy[None], M)[0]
    points = warped_corners[:, ::-1]
    return img, _keep_inside(points, img.shape)


def draw_stripes(img, rng, max_nb_cols=13, transform_params=(0.05, 0.15)):
    H, W = img.shape
    n = int(rng.integers(5, max_nb_cols + 1))
    xs = np.sort(rng.uniform(0.1 * W, 0.9 * W, n))
    xs = np.concatenate([[0], xs, [W - 1]])
    M = _random_homography_for_grid(rng, (H, W), strength=float(rng.uniform(*transform_params)))
    board = np.zeros_like(img)
    for i in range(len(xs) - 1):
        col = _random_color(rng)
        quad = np.array(
            [[xs[i], 0], [xs[i + 1], 0], [xs[i + 1], H - 1], [xs[i], H - 1]],
            np.float32,
        )
        warped = cv_draw.perspective_transform(quad[None], M)[0]
        cv_draw.fill_poly(board, [warped.astype(np.int32)], col)
    mask = np.zeros_like(img)
    full = cv_draw.perspective_transform(
        np.array([[[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]]], np.float32), M
    )[0]
    cv_draw.fill_poly(mask, [full.astype(np.int32)], 255)
    img[mask > 0] = board[mask > 0]
    corners_xy = np.stack(
        [np.concatenate([xs, xs]), np.concatenate([np.zeros_like(xs), np.full_like(xs, H - 1)])],
        -1,
    ).astype(np.float32)
    warped_corners = cv_draw.perspective_transform(corners_xy[None], M)[0]
    points = warped_corners[:, ::-1]
    return img, _keep_inside(points, img.shape)


def draw_cube(img, rng, min_size_ratio=0.2):
    """Project a random 3D cube; corners are the visible vertices."""
    H, W = img.shape
    min_dim = min(H, W)
    lx = min_dim * rng.uniform(min_size_ratio, 0.4)
    ly = min_dim * rng.uniform(min_size_ratio, 0.4)
    lz = min_dim * rng.uniform(min_size_ratio, 0.4)
    cube = np.array(
        [
            [0, 0, 0], [lx, 0, 0], [0, ly, 0], [lx, ly, 0],
            [0, 0, lz], [lx, 0, lz], [0, ly, lz], [lx, ly, lz],
        ],
        np.float32,
    )
    rot_angles = rng.uniform(-math.pi / 4, math.pi / 4, 3)
    cx, cy, cz = np.cos(rot_angles)
    sx, sy, sz = np.sin(rot_angles)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    R = Rz @ Ry @ Rx
    cube = cube @ R.T
    # orthographic projection + center placement
    proj = cube[:, :2]
    span = proj.max(0) - proj.min(0)
    margin_x = max((W - span[0]) / 2, 1)
    margin_y = max((H - span[1]) / 2, 1)
    offset = np.array(
        [
            rng.uniform(0.3, 0.7) * 2 * margin_x - proj.min(0)[0],
            rng.uniform(0.3, 0.7) * 2 * margin_y - proj.min(0)[1],
        ]
    )
    proj = proj + offset
    # faces sharing vertex 7 (the one with max depth after rotation) are
    # drawn; use painter's order on z
    order = np.argsort(cube[:, 2])
    front = order[-1]  # vertex closest to viewer (max z)
    faces = [f for f in (
        (0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
        (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5),
    ) if front in f]
    mean = int(img.mean())
    visible = set()
    for f in faces[:3]:
        col = _random_color(rng, mean)
        quad = proj[list(f)].astype(np.int32)
        cv_draw.fill_poly(
            img, [_ccw_sort(quad.astype(np.float32)).astype(np.int32)], col)
        visible.update(f)
    thickness = max(1, min_dim // 100)
    for f in faces[:3]:
        for a, b in zip(f, f[1:] + f[:1]):
            cv_draw.line(
                img,
                tuple(proj[a].astype(int)),
                tuple(proj[b].astype(int)),
                0,
                thickness,
            )
    points = proj[sorted(visible)][:, ::-1]
    return img, _keep_inside(points, img.shape)


def gaussian_noise(img, rng, cv_rng=None):
    randu(img, 0, 255, cv_rng)
    return img, np.zeros((0, 2), np.float32)


DRAW_FNS = {
    "draw_lines": draw_lines,
    "draw_polygon": draw_polygon,
    "draw_multiple_polygons": draw_multiple_polygons,
    "draw_ellipses": draw_ellipses,
    "draw_star": draw_star,
    "draw_checkerboard": draw_checkerboard,
    "draw_stripes": draw_stripes,
    "draw_cube": draw_cube,
    "gaussian_noise": gaussian_noise,
}


def generate_sample(primitive: str, rng, image_size=(960, 1280), params=None,
                    cv_rng=None):
    """Background + primitive -> (uint8 image, (N, 2) float (y, x) points);
    ``cv_rng`` (default: the calling thread's) feeds the random fills."""
    params = params or {}
    bg_params = params.get("generate_background", {})
    img = generate_background(image_size, rng, cv_rng=cv_rng, **bg_params)
    fn = DRAW_FNS[primitive]
    prim_params = dict(params.get(primitive, {}))
    if primitive == "gaussian_noise":
        prim_params["cv_rng"] = cv_rng
    img, points = fn(img, rng, **prim_params)
    return img, points.astype(np.float32)
