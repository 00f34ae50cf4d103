"""Dataset-format readers: COLMAP (binary), NeRF-synthetic, single-image
and image + depth layouts (counterpart of
`splatter_a_video_tpu/data/readers.py`, numpy only).

A reader returns an immutable `SceneFrames` bundle (numpy cameras, image
paths or in-memory images, an optional init point cloud) that a trainer
moves to the device once. Extrinsic = world->camera [R|t] in OpenCV axes;
R is the actual rotation (the reference stored it transposed). `imageio`
is imported only when an image file is read.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models import camera as camera_lib
from ..utils.registry import Registry

DATA_FORMAT = Registry("DATA_FORMAT")

# COLMAP camera model table (model_id -> name, #params). Matches
# `colmap_utils.py:40-46`; only the pinhole families are accepted.
_COLMAP_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _qvec2rotmat_np(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> rotation matrix in float64 (the
    formula of `utils/pose.qvec2rotmat`, kept on the host for parsing)."""
    w, x, y, z = (float(v) for v in q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


@dataclass(frozen=True)
class PointCloudData:
    """Init point cloud (reference `SimplePointCloud`, `base_data.py`)."""

    positions: np.ndarray  # [N, 3] float32
    colors: np.ndarray  # [N, 3] float32 in [0, 1]
    normals: Optional[np.ndarray] = None  # [N, 3] or None


@dataclass(frozen=True)
class SceneFrames:
    """One split of a multi-view scene: per-frame cameras and image paths.

    `images`, when given, holds the frames in memory ([H, W, 3 or 4]
    float in [0, 1], or uint8) and is read in place of `image_paths`: a
    scene rendered or decoded by the caller needs no image files."""

    cameras: Tuple[camera_lib.Camera, ...]
    image_paths: Tuple[str, ...]
    depth_paths: Tuple[str, ...] = ()
    pointcloud: Optional[PointCloudData] = None
    backgrounds: Tuple[float, ...] = ()
    metadata: Dict[str, object] = field(default_factory=dict)
    images: Tuple[np.ndarray, ...] = ()

    def __len__(self) -> int:
        return len(self.cameras)

    def load_image(self, i: int) -> np.ndarray:
        """[H, W, 3] float32 in [0,1]; alpha composited over the background."""
        if self.images:
            img = np.asarray(self.images[i])
            img = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img.astype(np.float32)
        else:
            img = _read_image(self.image_paths[i]).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.shape[-1] == 4:
            bg = self.backgrounds[i] if self.backgrounds else 0.0
            alpha = img[..., 3:4]
            img = img[..., :3] * alpha + bg * (1.0 - alpha)
        return img[..., :3]

    def load_depth(self, i: int) -> Optional[np.ndarray]:
        if not self.depth_paths or not self.depth_paths[i]:
            return None
        path = self.depth_paths[i]
        if path.endswith(".npy"):
            return np.load(path).astype(np.float32)
        return _read_image(path).astype(np.float32)

    def camera_extent(self) -> float:
        return camera_extent(self.cameras)


def _read_image(path: str) -> np.ndarray:
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


def camera_extent(cameras: Sequence[camera_lib.Camera]) -> float:
    """Scene radius = 1.1 x the camera-center bounding-sphere diagonal —
    the `getNerfppNorm` rule (`dataset_utils.py:15-36`) that scales
    position learning rates (spatial_lr_scale)."""
    centers = np.stack([c.camera_center for c in cameras], axis=0)
    dist = np.linalg.norm(centers - centers.mean(axis=0), axis=1)
    return float(dist.max() * 1.1) if len(cameras) > 1 else 1.0


# ---------------------------------------------------------------------------
# COLMAP binary parsing (`colmap_utils.py:49-131`), numpy-vectorized where
# the record layout allows.
# ---------------------------------------------------------------------------


def read_colmap_intrinsics(path: str) -> Dict[int, dict]:
    """cameras.bin -> {camera_id: {model, width, height, params}}."""
    out: Dict[int, dict] = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = _COLMAP_MODELS[model_id]
            params = np.frombuffer(f.read(8 * n_params), dtype="<f8")
            out[cam_id] = dict(model=name, width=int(w), height=int(h),
                               params=np.asarray(params))
    return out


def read_colmap_extrinsics(path: str) -> Dict[int, dict]:
    """images.bin -> {image_id: {qvec, tvec, camera_id, name}}.

    The per-image 2D point table (24 bytes/point) is skipped wholesale
    instead of being unpacked value-by-value as the reference does
    (`colmap_utils.py:64-71`) — Gaussian init never uses it."""
    out: Dict[int, dict] = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            rec = struct.unpack("<idddddddi", f.read(64))
            name_bytes = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (n_pts,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n_pts, os.SEEK_CUR)
            out[rec[0]] = dict(
                qvec=np.array(rec[1:5]),
                tvec=np.array(rec[5:8]),
                camera_id=rec[8],
                name=name_bytes.decode("utf-8"),
            )
    return out


def read_colmap_points3d(path: str) -> PointCloudData:
    """points3D.bin -> PointCloudData. Variable-length track records force
    a scan, but each fixed 43-byte head is decoded vectorized-at-the-end."""
    heads: List[bytes] = []
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            heads.append(f.read(43))  # <Q ddd BBB d
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.seek(8 * track_len, os.SEEK_CUR)
    buf = b"".join(heads)
    xyz = np.zeros((num, 3), np.float64)
    rgb = np.zeros((num, 3), np.float64)
    for i in range(num):
        rec = struct.unpack_from("<QdddBBBd", buf, 43 * i)
        xyz[i] = rec[1:4]
        rgb[i] = rec[4:7]
    return PointCloudData(
        positions=xyz.astype(np.float32),
        colors=(rgb / 255.0).astype(np.float32),
    )


def read_ply_pointcloud(path: str) -> PointCloudData:
    """Minimal binary-little-endian PLY vertex reader (float/double/uchar
    properties), replacing the reference's plyfile dependency
    (`colmap_utils.py:101-111`)."""
    dtypes = {"float": "<f4", "float32": "<f4", "double": "<f8",
              "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
              "short": "<i2", "ushort": "<u2"}
    with open(path, "rb") as f:
        props: List[Tuple[str, str]] = []
        n = 0
        in_vertex = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element"):
                _, name, count = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(count)
            elif line.startswith("property") and in_vertex:
                _, typ, pname = line.split()
                props.append((pname, dtypes[typ]))
            elif line == "end_header":
                break
        table = np.frombuffer(
            f.read(), dtype=np.dtype([(p, d) for p, d in props]), count=n
        )
    pos = np.stack([table["x"], table["y"], table["z"]], axis=1).astype(np.float32)
    names = {p for p, _ in props}
    colors = None
    if {"red", "green", "blue"} <= names:
        colors = np.stack(
            [table["red"], table["green"], table["blue"]], axis=1
        ).astype(np.float32)
        if colors.max() > 1.0:
            colors /= 255.0
    normals = None
    if {"nx", "ny", "nz"} <= names:
        normals = np.stack([table["nx"], table["ny"], table["nz"]], axis=1).astype(
            np.float32
        )
    if colors is None:
        colors = np.full_like(pos, 0.5)
    return PointCloudData(positions=pos, colors=colors, normals=normals)


# ---------------------------------------------------------------------------
# Format readers
# ---------------------------------------------------------------------------


@DATA_FORMAT.register("ColmapReFormat")
def read_colmap_scene(
    data_root: str, split: str = "train", scale: float = 1.0, llffhold: int = 8
) -> SceneFrames:
    """COLMAP sparse-reconstruction layout (`colmap_data.py:13-135`):
    `sparse/0/{cameras,images,points3D}.bin` + `images/`. Every llffhold-th
    frame (by filename order) is the val split, as in the reference."""
    sparse = os.path.join(data_root, "sparse", "0")
    intr = read_colmap_intrinsics(os.path.join(sparse, "cameras.bin"))
    extr = read_colmap_extrinsics(os.path.join(sparse, "images.bin"))

    entries = []
    for image_id, e in extr.items():
        k = intr[e["camera_id"]]
        w, h = k["width"] * scale, k["height"] * scale
        if k["model"] == "SIMPLE_PINHOLE":
            fx = fy = k["params"][0] * scale
        elif k["model"] == "PINHOLE":
            fx, fy = k["params"][0] * scale, k["params"][1] * scale
        else:
            raise ValueError(
                f"COLMAP camera model {k['model']} not supported: only "
                "undistorted PINHOLE / SIMPLE_PINHOLE datasets"
            )
        cam = camera_lib.Camera(
            width=int(round(w)),
            height=int(round(h)),
            R=_qvec2rotmat_np(e["qvec"]).astype(np.float32),
            t=e["tvec"].astype(np.float32),
            fovx=camera_lib.focal2fov(fx, int(round(w))),
            fovy=camera_lib.focal2fov(fy, int(round(h))),
        )
        entries.append((os.path.basename(e["name"]), cam))
    entries.sort(key=lambda kv: kv[0])
    keep = (
        (lambda i: i % llffhold != 0) if split == "train" else (lambda i: i % llffhold == 0)
    )
    entries = [kv for i, kv in enumerate(entries) if keep(i)]

    ply_path = os.path.join(sparse, "points3D.ply")
    bin_path = os.path.join(sparse, "points3D.bin")
    pcd = None
    if os.path.exists(ply_path):
        pcd = read_ply_pointcloud(ply_path)
    elif os.path.exists(bin_path):
        pcd = read_colmap_points3d(bin_path)

    depth_dir = next(
        (
            os.path.join(data_root, d)
            for d in ("depth", "depths")
            if os.path.isdir(os.path.join(data_root, d))
        ),
        None,
    )
    depth_paths: Tuple[str, ...] = ()
    if depth_dir:
        files = sorted(os.listdir(depth_dir))
        if len(files) >= len(entries):
            depth_paths = tuple(os.path.join(depth_dir, f) for f in files[: len(entries)])

    return SceneFrames(
        cameras=tuple(c for _, c in entries),
        image_paths=tuple(os.path.join(data_root, "images", n) for n, _ in entries),
        depth_paths=depth_paths,
        pointcloud=pcd,
        backgrounds=tuple(0.0 for _ in entries),
    )


@DATA_FORMAT.register("NerfReFormat")
def read_nerf_synthetic_scene(
    data_root: str, split: str = "train", scale: float = 1.0
) -> SceneFrames:
    """NeRF-synthetic layout (`nerf_data.py:14-105`): transforms_train/
    test.json with OpenGL c2w matrices; axes flipped to OpenCV, white bg."""
    fname = "transforms_train.json" if split == "train" else "transforms_test.json"
    with open(os.path.join(data_root, fname)) as f:
        meta = json.load(f)
    fovx = float(meta["camera_angle_x"])

    cameras, paths = [], []
    for frame in meta["frames"]:
        rel = frame["file_path"]
        path = os.path.join(data_root, rel + ("" if rel.endswith(".png") else ".png"))
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL (y up, z back) -> OpenCV (y down, z fwd)
        w2c = np.linalg.inv(c2w)
        with open(path, "rb") as imf:  # PNG IHDR: width/height at bytes 16-24
            imf.seek(16)
            w_px, h_px = struct.unpack(">II", imf.read(8))
        cameras.append(
            camera_lib.Camera(
                width=w_px,
                height=h_px,
                R=w2c[:3, :3].astype(np.float32),
                t=w2c[:3, 3].astype(np.float32),
                fovx=fovx,
                fovy=camera_lib.focal2fov(
                    camera_lib.fov2focal(fovx, w_px), h_px
                ),
            )
        )
        paths.append(path)
    return SceneFrames(
        cameras=tuple(cameras),
        image_paths=tuple(paths),
        backgrounds=tuple(1.0 for _ in cameras),
    )


def _single_image_camera(image_path: str, z: float) -> camera_lib.Camera:
    """Fixed fovx=pi/2 camera looking at an image plane, translated to z
    (the Image/ImageDepth readers' shared construction,
    `image_data.py:46-66`)."""
    c2w = np.eye(4)
    c2w[:3, 3] = [0.0, 0.0, z]
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    img = _read_image(image_path)
    h, w = img.shape[:2]
    return camera_lib.Camera(
        width=w,
        height=h,
        R=w2c[:3, :3].astype(np.float32),
        t=w2c[:3, 3].astype(np.float32),
        fovx=np.pi / 2.0,
        fovy=camera_lib.focal2fov(camera_lib.fov2focal(np.pi / 2.0, w), h),
    )


@DATA_FORMAT.register("ImageReFormat")
def read_image_scene(data_root: str, split: str = "train", scale: float = 1.0) -> SceneFrames:
    """Single-image fit (`image_data.py:15-94`): data_root IS the image;
    one camera at z=2 looking back at the plane."""
    cam = _single_image_camera(data_root, z=2.0)
    return SceneFrames(cameras=(cam,), image_paths=(data_root,), backgrounds=(1.0,))


@DATA_FORMAT.register("ImageDepthReFormat")
def read_image_depth_scene(
    data_root: str, split: str = "train", scale: float = 1.0
) -> SceneFrames:
    """Single image + sibling `depth_npy/` folder (`imageDepth_data.py`):
    camera at origin; init point cloud unprojected from the first depth map
    with the reference's +0.5 z-shift and OpenGL flips (`:100-135`)."""
    cam = _single_image_camera(data_root, z=0.0)
    depth_dir = os.path.join(os.path.dirname(data_root), "depth_npy")
    pcd = None
    depth_paths: Tuple[str, ...] = ()
    if os.path.isdir(depth_dir):
        files = sorted(os.listdir(depth_dir))
        if files:
            depth_path = os.path.join(depth_dir, files[0])
            depth = np.load(depth_path)
            pts = _depth_to_pointcloud(depth)
            colors = (
                _read_image(data_root)[..., :3].reshape(-1, 3).astype(np.float32)
                / 255.0
            )
            pcd = PointCloudData(positions=pts.reshape(-1, 3), colors=colors)
            depth_paths = (depth_path,)
    return SceneFrames(
        cameras=(cam,),
        image_paths=(data_root,),
        depth_paths=depth_paths,
        pointcloud=pcd,
        backgrounds=(1.0,),
    )


def _depth_to_pointcloud(depth: np.ndarray) -> np.ndarray:
    """Unproject a depth map through the fovx=pi/2 camera into OpenGL axes —
    `ImageDepthReFormat.depth2pcd` (`imageDepth_data.py:107-135`)."""
    h, w = depth.shape
    focal = camera_lib.fov2focal(np.pi / 2.0, w)
    i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = depth + 0.5
    x = (j - w * 0.5) * z / focal
    y = -(i - h * 0.5) * z / focal
    return np.stack([x, y, -z], axis=-1).astype(np.float32)


def parse_data_format(name: str):
    """Registry lookup mirroring `parse_data_pipeline`
    (`src/pointrix/dataset/__init__.py:12-26`)."""
    return DATA_FORMAT.get(name)
