"""OpenCV's integer rasteriser for 8-bit single-channel images, in
Python, numpy and C++ (no cv2 on the card's machine).

Byte-equal copies of what ``cv2.line``, ``cv2.circle`` (filled),
``cv2.fillPoly`` and ``cv2.ellipse`` (filled) draw at ``lineType`` 8 and
``shift`` 0, the defaults the synthetic shapes use, and of
``cv2.getPerspectiveTransform`` / ``cv2.perspectiveTransform``.

OpenCV draws in 16.16 fixed point (``XY_SHIFT``): a line of thickness 1 is
an 8-connected Bresenham walk from its left end, clipped to the image by
``clipLine``; a thick line is clipped to the image grown by its thickness,
then drawn as a convex quadrilateral filled by ``FillConvexPoly`` (whose
edges are drawn by ``Line2``, a fixed-point DDA) plus a filled circle of
radius ``thickness / 2`` at each end. A
filled circle is the union of the horizontal spans its midpoint walk
visits. ``fillPoly`` draws every edge as a line first, then fills by an
active-edge scan (``FillEdgeCollection``), so polygons may be non-convex
and self-touching; an edge that leaves the image is kept from its
clipped ends' columns (so the part outside runs along the border). The
spans take the columns from ceil(left edge) to floor(right edge). A filled ellipse rounds its angle to an integer
degree, becomes a polygon by ``ellipse2Poly`` (OpenCV's float table of
sines, a step of 5-90 degrees by axis size) and is filled as a convex
polygon. The C arithmetic is kept: truncating integer division, ``cvRound``
(half to even), 64-bit coordinates.

``clipLine``, the 8-connected line and ``FillConvexPoly`` with its edges
run in C++ (``native/cv_draw.cpp``, built by g++ at first use): in
Python the fixed-point edge walks of the 20 ellipses the photometric
shade draws took most of an augmented image's time.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spnerf_tpu_torch.utils import native

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# OpenCV's SinTable: sin(i degrees) rounded to 7 decimals, as float32,
# i = 0..450 (cos(a) is read at 450 - a)
SIN_TABLE = np.array(
    [float(f"{np.sin(np.deg2rad(i)):.7f}") for i in range(451)], np.float32)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img, y: int, x1: int, x2: int, color: int) -> None:
    img[y, x1:x2 + 1] = color


def _native():
    lib = native.load("cv_draw")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.cv_clip_line.argtypes = [i64, i64, ptr]
    lib.cv_clip_line.restype = ctypes.c_int
    lib.cv_line8.argtypes = [ptr, i64, i64, i64, i64, i64, i64, i32]
    lib.cv_fill_convex_poly.argtypes = [ptr, i64, i64, ptr, i64, i32, i32]
    lib.cv_line8.restype = lib.cv_fill_convex_poly.restype = None
    return lib


def _canvas(img, color: int):
    """The image's buffer for the C++ passes, which draw in place."""
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
            and img.ndim == 2 and img.flags.c_contiguous
            and img.flags.writeable):
        raise ValueError("cv_draw draws on a writeable C-contiguous (H, W) "
                         "uint8 array")
    if not 0 <= color <= 255:
        raise ValueError(f"cv_draw: colour {color} is not a uint8 value")
    return img.ctypes.data, img.shape[0], img.shape[1]


def clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """``cv::clipLine`` on an image of ``width`` x ``height``: (inside,
    x1, y1, x2, y2) with the end points moved onto the border."""
    pts = np.array([x1, y1, x2, y2], np.int64)
    ok = _native().cv_clip_line(width, height, pts.ctypes.data)
    return bool(ok), *(int(v) for v in pts)


def _bresenham(img, x1: int, y1: int, x2: int, y2: int, color: int) -> None:
    """``cv::Line`` at connectivity 8: ``LineIterator`` from the left end
    (``leftToRight``), clipped first where an end lies outside."""
    _native().cv_line8(*_canvas(img, color), x1, y1, x2, y2, color)


def _circle_filled(img, cx: int, cy: int, radius: int, color: int) -> None:
    """``cv::Circle`` with ``fill``: the spans [cx - dx, cx + dx] at rows
    cy +- dy and [cx - dy, cx + dy] at rows cy +- dx of the midpoint walk
    (all centred, so each row keeps its widest)."""
    h, w = img.shape
    half = np.full(radius + 1, -1, np.int64)  # widest half-span at |row|
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        half[dy] = max(half[dy], dx)
        half[dx] = max(half[dx], dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    offs = np.arange(-radius, radius + 1)
    rows = cy + offs
    spans = half[np.abs(offs)]
    for y, s in zip(rows.tolist(), spans.tolist()):
        if s < 0 or not 0 <= y < h:
            continue
        x1, x2 = max(cx - s, 0), min(cx + s, w - 1)
        if x1 <= x2:
            _hline(img, y, x1, x2, color)


def _fill_convex_poly(img, pts, color: int, shift: int) -> None:
    """``cv::FillConvexPoly`` at line type 8: the edges drawn as lines,
    then the spans between the two chains that start at the top vertex."""
    pts = np.ascontiguousarray(pts, np.int64).reshape(-1, 2)
    _native().cv_fill_convex_poly(*_canvas(img, color), pts.ctypes.data,
                                  len(pts), color, shift)


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_poly_edges(img, pts, edges: list, color: int) -> None:
    """``CollectPolyEdges`` at shift 0 and line type 8: each edge drawn as
    a line, and kept (unless horizontal) from its clipped ends."""
    h, w = img.shape
    x0, y0 = pts[-1]
    x0 <<= XY_SHIFT
    for x1, y1 in pts:
        x1 <<= XY_SHIFT
        t0x = (x0 + (XY_ONE >> 1)) >> XY_SHIFT
        t1x = (x1 + (XY_ONE >> 1)) >> XY_SHIFT
        t0y, t1y = y0, y1
        _bresenham(img, t0x, t0y, t1x, t1y, color)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= t0y < h
                and 0 <= t1y < h):
            _, t0x, t0y, t1x, t1y = clip_line(w, h, t0x, t0y, t1x, t1y)
            if t0y != t1y:
                c0y, c1y = t0y, t1y
            c0x, c1x = t0x << XY_SHIFT, t1x << XY_SHIFT
        if y0 != y1:
            dx = _cdiv(c1x - c0x, c1y - c0y)
            if y0 < y1:
                edges.append(_Edge(y0, y1, c0x + (y0 - c0y) * dx, dx))
            else:
                edges.append(_Edge(y1, y0, c1x + (y1 - c1y) * dx, dx))
        x0, y0 = x1, y1


def _fill_edge_collection(img, edges: list, color: int) -> None:
    """``FillEdgeCollection`` at line type 8: OpenCV's active-edge scan,
    its list order and bubble sort kept (the x of an edge advances only on
    the rows where it bounds a drawn span)."""
    h, w = img.shape
    total = len(edges)
    if total < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    ends = [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    x_min = min(min(e.x for e in edges), min(ends))
    x_max = max(max(e.x for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e.y0, e.x, e.dx))
    sentinel = _Edge(y0=2**31 - 1)
    edges.append(sentinel)
    head = _Edge()  # OpenCV's "tmp": the active list's head
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    y = e.y0
    while y < y_max:
        draw = False
        clip = y < 0
        prelast = head
        last = head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next  # the edge ends above this row
                last = last.next
                continue
            keep = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast = last
                last = last.next
            elif i < total:
                prelast.next = e  # the edge starts at this row
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if not clip:
                    if keep.x > prelast.x:
                        x1 = (prelast.x + XY_ONE - 1) >> XY_SHIFT
                        x2 = keep.x >> XY_SHIFT
                    else:
                        x1 = (keep.x + XY_ONE - 1) >> XY_SHIFT
                        x2 = prelast.x >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        _hline(img, y, max(x1, 0), min(x2, w - 1), color)
                keep.x += keep.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble sort of the active list by x
        keep = None
        while True:
            prelast = head
            last = head.next
            exchanged = None
            while last is not keep and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    exchanged = prelast
                else:
                    prelast = last
                    last = te
            if exchanged is None:
                break
            keep = exchanged
            if keep is head.next or keep is head:
                break
        y += 1


def _points(pts) -> list:
    return [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]


def line(img, pt1, pt2, color: int, thickness: int = 1) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness)`` on an (H, W) uint8
    image, in place; points are (x, y)."""
    (x1, y1), (x2, y2) = _points([pt1, pt2])
    if not 0 < thickness <= 32767:
        raise ValueError(f"line: thickness {thickness}")
    if thickness == 1:
        _bresenham(img, x1, y1, x2, y2, color)
        return
    # clipped first to the image grown by the thickness on every side
    h, w = img.shape
    t = thickness
    ok, x1, y1, x2, y2 = clip_line(w + 2 * t, h + 2 * t, x1 + t, y1 + t,
                                   x2 + t, y2 + t)
    if not ok:
        return
    x1, y1, x2, y2 = ((v - t) << XY_SHIFT for v in (x1, y1, x2, y2))
    dxf = (x1 - x2) / XY_ONE
    dyf = (y2 - y1) / XY_ONE
    r = dxf * dxf + dyf * dyf
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = round(dyf * r), round(dxf * r)
        quad = [(x1 + dpx, y1 + dpy), (x1 - dpx, y1 - dpy),
                (x2 - dpx, y2 - dpy), (x2 + dpx, y2 + dpy)]
        _fill_convex_poly(img, quad, color, XY_SHIFT)
    rad = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for x, y in ((x1, y1), (x2, y2)):
        _circle_filled(img, (x + (XY_ONE >> 1)) >> XY_SHIFT,
                       (y + (XY_ONE >> 1)) >> XY_SHIFT, rad, color)


def circle(img, center, radius: int, color: int) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` (filled), in place."""
    (cx, cy), = _points([center])
    if radius < 0:
        raise ValueError(f"circle: radius {radius}")
    _circle_filled(img, cx, cy, int(radius), color)


def fill_poly(img, polygons, color: int) -> None:
    """``cv2.fillPoly(img, polygons, color)`` (a list of (N, 2) int (x, y)
    arrays, filled together by the even-odd scan), in place."""
    edges: list = []
    for poly in polygons:
        pts = _points(poly)
        if pts:
            _collect_poly_edges(img, pts, edges, color)
    _fill_edge_collection(img, edges, color)


def ellipse2poly(center, axes, angle: int, arc_start: int, arc_end: int,
                 delta: int) -> list:
    """``cv::ellipse2Poly``'s float64 vertices (Point2d overload)."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    a = angle + (360 if angle < 0 else 0)
    beta = float(SIN_TABLE[a])
    alpha = float(SIN_TABLE[450 - a])
    out = []
    for i in range(arc_start, arc_end + delta, delta):
        ang = min(i, arc_end)
        if ang < 0:
            ang += 360
        x = axes[0] * float(SIN_TABLE[450 - ang])
        y = axes[1] * float(SIN_TABLE[ang])
        out.append((center[0] + x * alpha - y * beta,
                    center[1] + x * beta + y * alpha))
    if len(out) == 1:
        out = [tuple(center)] * 2
    return out


def ellipse(img, center, axes, angle: float, color: int) -> None:
    """``cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)``
    (filled), in place: the angle rounded to a degree (half to even)."""
    (cx, cy), = _points([center])
    aw, ah = (abs(int(v)) << XY_SHIFT for v in axes)
    cx, cy = cx << XY_SHIFT, cy << XY_SHIFT
    delta = (max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    verts = ellipse2poly((float(cx), float(cy)), (float(aw), float(ah)),
                         round(float(angle)), 0, 360, delta)
    pts = []
    for vx, vy in verts:
        pt = (round(vx), round(vy))
        if not pts or pt != pts[-1]:
            pts.append(pt)
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    _fill_convex_poly(img, pts, color, XY_SHIFT)


def get_perspective_transform(src, dst) -> np.ndarray:
    """``cv2.getPerspectiveTransform``: the 3 x 3 float64 homography
    mapping four float32 (x, y) points onto four, from OpenCV's 8 x 8
    system (its products of coordinates in float32) solved by LU with
    partial pivoting (``DECOMP_LU``), h33 = 1."""
    src = np.asarray(src, np.float32).reshape(4, 2)
    dst = np.asarray(dst, np.float32).reshape(4, 2)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (x, y), (u, v) = src[i], dst[i]
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(_lu_solve(a, b), 1.0).reshape(3, 3)


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OpenCV's ``LUImpl`` (``hal::LU64f``): Gaussian elimination with
    partial pivoting in float64, then back substitution in its order."""
    a = a.copy()
    b = b.copy()
    m = len(a)
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(a[j, i]) > abs(a[k, i]):
                k = j
        if abs(a[k, i]) < np.finfo(np.float64).eps * 100:
            raise ValueError("get_perspective_transform: singular system")
        if k != i:
            a[[i, k]] = a[[k, i]]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, m):
            alpha = a[j, i] * d
            for c in range(i + 1, m):
                a[j, c] += alpha * a[i, c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, m):
            s -= a[i, k] * b[k]
        b[i] = s / a[i, i]
    return b


def perspective_transform(points, m: np.ndarray) -> np.ndarray:
    """``cv2.perspectiveTransform`` of float32 (..., 2) points by a 3 x 3
    float64 matrix: each output in float64, w' = 1 / w where |w| exceeds
    float32's epsilon (else the point maps to 0), stored as float32."""
    pts = np.asarray(points, np.float32)
    x = pts[..., 0].astype(np.float64)
    y = pts[..., 1].astype(np.float64)
    m = np.asarray(m, np.float64)
    w = x * m[2, 0] + y * m[2, 1] + m[2, 2]
    big = np.abs(w) > np.finfo(np.float32).eps
    w = np.where(big, 1.0 / np.where(big, w, 1.0), 0.0)
    out = np.stack([(x * m[0, 0] + y * m[0, 1] + m[0, 2]) * w,
                    (x * m[1, 0] + y * m[1, 1] + m[1, 2]) * w], axis=-1)
    return out.astype(np.float32)
