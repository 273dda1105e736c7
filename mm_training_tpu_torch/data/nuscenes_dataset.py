"""The nuScenes multi-view dataset (the BEVDepth-original path).

The port of ``mm_training_tpu/data/nuscenes_dataset.py`` (the reference's
dataset/nusc_mv_det_dataset.py, NuscMVDetDataset): it reads the info
pickles of ``scripts/gen_info.py`` and yields the fixed-shape sample dict
of the aiMotive dataset, so one trainer serves both. Its samples are the
JAX package's, byte for byte. As there:

  * the image augmentation (resize, crop, flip) is an ida matrix folded
    into each camera's intrinsic (intrin' = ida @ intrin); nuScenes rigs
    have roll and pitch, so a camera model takes the general splat
    (``configs.raw_rig``, kernel K8);
  * CBGS (class-balanced group sampling, the reference's :212-245) is an
    index table drawn again each epoch (``set_epoch``);
  * every draw is keyed on (seed, epoch, index);
  * samples are padded to fixed shapes (``max_objs``, ``max_points``).

Images are read by the port's own codec (``data/image.py::imread``, equal
to ``cv2.imread`` byte for byte) and resized by ``resize_linear``
(``cv2.resize`` with INTER_LINEAR). A missing image file gives the zero
image, as ``cv2.imread``'s None does in the JAX package; a JPEG the codec
does not decode exactly raises ValueError naming the file and the feature.

Depth ground truth, two sources:
  * the LIDAR_TOP frame and its sweeps, motion-compensated into the key
    frame's ego pose (the reference's :506-535), in ``points``: the train
    step projects them through the folded intrinsics (kernel K6);
  * with ``Config.depth_gt_root``, the (u, v, depth) bins of
    ``scripts/gen_depth_gt.py --dataset nuscenes``, mapped through the
    sampled ida and rasterized per camera into ``depth_gt`` (the
    reference's :387-396 path), which K6's ``depth_grid_to_onehot`` bins:
    a camera-only model then trains on a real depth loss without LiDAR
    files. A missing bin warns once and gives an empty grid.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.spatial.transform import Rotation

from ..configs import Config
from ..core.transforms import bda_transform, sample_bda
from .image import imread, resize_linear

__all__ = ['NUSC_CLASSES', 'NuscMVDetDataset']

NUSC_CLASSES = ('car', 'truck', 'construction_vehicle', 'bus', 'trailer',
                'barrier', 'motorcycle', 'bicycle', 'pedestrian',
                'traffic_cone')

_CAMS = ('CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
         'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT')


def _quat_to_mat(q) -> np.ndarray:
    """nuScenes [w, x, y, z] quaternion -> rotation matrix."""
    w, x, y, z = q
    return Rotation.from_quat([x, y, z, w]).as_matrix()


def _pose_to_mat(rec) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = _quat_to_mat(rec['rotation'])
    m[:3, 3] = rec['translation']
    return m


class NuscMVDetDataset:
    """Map-style dataset over gen_info.py pickles."""

    def __init__(self, info_path: str, cfg: Config, data_root: str,
                 classes: Sequence[str] = NUSC_CLASSES, is_train: bool = True,
                 use_cbgs: bool = False, cams: Sequence[str] = _CAMS):
        with open(info_path, 'rb') as f:
            self.infos: List[Dict] = pickle.load(f)
        self.cfg = cfg
        self.data_root = data_root
        if cfg.use_cam and cfg.get_backbone_conf().factorized_splat:
            import warnings
            warnings.warn(
                'factorized_splat assumes zero-roll/pitch (virtualized) '
                'cameras; raw nuScenes rigs have roll/pitch — set '
                'BackboneConf(factorized_splat=False) for exact geometry',
                stacklevel=2)
        self.classes = tuple(classes)
        self.is_train = is_train
        self.cams = tuple(cams)[:cfg.num_cameras]
        self.epoch = 0
        self.use_cbgs = use_cbgs
        self.idx_map = (self._cbgs_indices() if use_cbgs
                        else np.arange(len(self.infos)))

    # ------------------------------------------------------------------ CBGS
    def _cbgs_indices(self) -> np.ndarray:
        """Class-balanced resampling (nusc_mv_det_dataset.py:212-245): each
        class gets ~1/n_cls of the duplicated index pool."""
        cls_to_samples: Dict[int, List[int]] = {i: [] for i in
                                                range(len(self.classes))}
        for idx, info in enumerate(self.infos):
            names = {a['category_name'] for a in info.get('ann_infos', [])}
            for ci, cls in enumerate(self.classes):
                if any(cls in n for n in names):
                    cls_to_samples[ci].append(idx)
        duplicated = sum(len(v) for v in cls_to_samples.values())
        if duplicated == 0:
            return np.arange(len(self.infos))
        frac = 1.0 / len(self.classes)
        out: List[int] = []
        rng = np.random.default_rng(self.cfg.seed * 1_000_003 + self.epoch)
        for v in cls_to_samples.values():
            if not v:
                continue
            ratio = duplicated * frac / len(v)
            take = rng.choice(v, int(len(v) * ratio)).tolist()
            out.extend(take)
        return np.asarray(out if out else np.arange(len(self.infos)))

    def __len__(self):
        return len(self.idx_map)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        # Deliberate improvement over the reference: _get_sample_indices
        # samples the CBGS indices ONCE at construction
        # (nusc_mv_det_dataset.py:212-245); resampling each epoch decorrelates
        # the duplication noise. Note the per-epoch dataset length can drift
        # slightly vs the epoch-0 length used for the LR schedule.
        if self.use_cbgs:
            self.idx_map = self._cbgs_indices()

    # ------------------------------------------------------------------- ida
    def _sample_ida(self, rng, src_hw):
        """Resize+crop (+flip) parameters (img_transform semantics,
        nusc_mv_det_dataset.py:48-151) with the BEVDepth default ranges."""
        H, W = src_hw
        fH, fW = self.cfg.final_dim
        if self.is_train:
            resize = float(rng.uniform(*(0.9, 1.1))) * fW / W
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int(newH - fH) if newH > fH else 0
            crop_h = int(rng.uniform(0, crop_h)) if crop_h else 0
            crop_w = int(rng.uniform(0, max(0, newW - fW)))
            flip = bool(rng.random() < 0.5)
        else:
            resize = max(fH / H, fW / W)
            newW, newH = int(W * resize), int(H * resize)
            crop_h = max(0, (newH - fH) // 2)
            crop_w = max(0, (newW - fW) // 2)
            flip = False
        return resize, (crop_w, crop_h), flip

    @staticmethod
    def _ida_mat(resize, crop, flip, fW):
        m = np.eye(4, dtype=np.float64)
        m[0, 0] = m[1, 1] = resize
        m[0, 3] = -crop[0]
        m[1, 3] = -crop[1]
        if flip:
            f = np.eye(4)
            f[0, 0] = -1
            f[0, 3] = fW - 1
            m = f @ m
        return m

    def _load_depth_gt(self, filename, resize, crop, flip) -> np.ndarray:
        """Read the precomputed (u, v, depth) bin for this camera image
        (scripts/gen_depth_gt.py --dataset nuscenes; reference format
        ``depth_gt/<image_basename>.bin``), apply the sampled ida to the
        image points (depth_transform, nusc_mv_det_dataset.py:106-151), and
        rasterize to the [fH/ds, fW/ds] min-depth grid the train step's
        ``depth_gt`` path consumes (train_step.py)."""
        from ..scripts.gen_depth_gt import uvd_to_depth_grid
        cfg = self.cfg
        fH, fW = cfg.final_dim
        ds = cfg.get_backbone_conf().downsample_factor
        path = os.path.join(cfg.depth_gt_root, 'depth_gt',
                            os.path.split(filename)[-1] + '.bin')
        if not os.path.isfile(path):
            # gen_depth_gt skips samples whose lidar file is absent (it
            # warns with a count); crashing mid-epoch inside the loader
            # pool would be worse than one degenerate depth target, so
            # warn once and fall back to an empty grid for this camera
            if not getattr(self, '_depth_gt_warned', False):
                self._depth_gt_warned = True
                import warnings
                warnings.warn(
                    f'missing depth-GT bin {path} (sample skipped by '
                    'gen_depth_gt, e.g. no lidar file) — using an empty '
                    'depth grid; further misses are silent')
            return uvd_to_depth_grid(np.zeros((0, 3)), (fH, fW),
                                     downsample=ds)
        uvd = np.fromfile(path, np.float32).reshape(-1, 3).astype(np.float64)
        u = uvd[:, 0] * resize - crop[0]
        v = uvd[:, 1] * resize - crop[1]
        if flip:
            u = (fW - 1) - u
        return uvd_to_depth_grid(np.stack([u, v, uvd[:, 2]], -1), (fH, fW),
                                 downsample=ds)

    def _load_image(self, filename, resize, crop, flip):
        fH, fW = self.cfg.final_dim
        path = os.path.join(self.data_root, filename)
        if not os.path.isfile(path):
            img = np.zeros((fH, fW, 3), np.uint8)
        else:
            img = imread(path)
            nh, nw = int(img.shape[0] * resize), int(img.shape[1] * resize)
            img = resize_linear(img, nh, nw)
            img = img[crop[1]:crop[1] + fH, crop[0]:crop[0] + fW]
            pad_h, pad_w = fH - img.shape[0], fW - img.shape[1]
            if pad_h > 0 or pad_w > 0:
                img = np.pad(img, ((0, max(0, pad_h)), (0, max(0, pad_w)),
                                   (0, 0)))
            if flip:
                img = img[:, ::-1]
        return img

    # ----------------------------------------------------------------- lidar
    def _load_lidar_points(self, info, rng) -> np.ndarray:
        """Key LIDAR_TOP frame + sweeps -> ego-frame points [P, 5|8].

        nuScenes .bin files are float32 [x, y, z, intensity, ring]; sweeps
        are motion-compensated into the key frame's ego pose
        (nusc_mv_det_dataset.py:506-535). Feature layout mirrors the
        aiMotive loader: [x, y, z, is_radar=0, speed=0(, power=0,
        intensity/255, ts_lag_s)]."""
        cfg = self.cfg
        li = info.get('lidar_infos', {}).get('LIDAR_TOP')
        n_feat = 8 if cfg.use_radar else 5
        if li is None:
            return np.zeros((0, n_feat), np.float32)
        key_ego_inv = np.linalg.inv(_pose_to_mat(li['ego_pose']))
        key_ts = li.get('timestamp', 0)
        clouds = []
        for rec in [li] + list(info.get('sweeps', [])):
            path = os.path.join(self.data_root, rec['filename'])
            if not os.path.isfile(path):
                continue
            raw = np.fromfile(path, np.float32).reshape(-1, 5)
            cal = rec['calibrated_sensor']
            s2e = np.eye(4)
            s2e[:3, :3] = _quat_to_mat(cal['rotation'])
            s2e[:3, 3] = cal['translation']
            t = key_ego_inv @ _pose_to_mat(rec['ego_pose']) @ s2e
            xyz = raw[:, :3] @ t[:3, :3].T + t[:3, 3]
            out = np.zeros((len(raw), n_feat), np.float32)
            out[:, :3] = xyz
            if n_feat == 8:
                out[:, 6] = raw[:, 3] / 255.0
                out[:, 7] = (key_ts - rec.get('timestamp', key_ts)) * 1e-6
            clouds.append(out)
        if not clouds:
            return np.zeros((0, n_feat), np.float32)
        pts = np.concatenate(clouds, 0)
        pc = cfg.point_cloud_range
        keep = ((pts[:, 0] >= pc[0]) & (pts[:, 0] <= pc[3])
                & (pts[:, 1] >= pc[1]) & (pts[:, 1] <= pc[4])
                & (pts[:, 2] >= pc[2]) & (pts[:, 2] <= pc[5]))
        pts = pts[keep]
        if len(pts) > cfg.max_points:
            pts = pts[rng.choice(len(pts), cfg.max_points, replace=False)]
        return pts

    # ------------------------------------------------------------------ item
    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        info = self.infos[int(self.idx_map[index])]
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + self.epoch * 97 + index) & 0x7FFFFFFF)

        # ONE reference frame for everything — the LIDAR_TOP ego pose when
        # lidar exists (where the points land), else the first camera's.
        # Each sensor's calibration is relative to its own timestamp's ego
        # pose; chaining through global realigns them (at highway speed the
        # lidar/camera ego poses differ by ~0.5-1 m).
        li = info.get('lidar_infos', {}).get('LIDAR_TOP')
        if li is not None:
            ref_ego = _pose_to_mat(li['ego_pose'])
        elif info['cam_infos']:
            ref_ego = _pose_to_mat(
                next(iter(info['cam_infos'].values()))['ego_pose'])
        else:
            ref_ego = np.eye(4)
        ref_ego_inv = np.linalg.inv(ref_ego)

        # camera sweeps = previous KEY FRAMES of the same scene (the
        # reference's key_idxes mechanism, nusc_mv_det_dataset.py:513-535);
        # a missing predecessor repeats the current frame
        raw_idx = int(self.idx_map[index])
        sweep_infos = [info]
        j = raw_idx
        for _ in range(1, cfg.num_sweeps):
            nj = j - 1
            if (nj >= 0 and self.infos[nj].get('scene_token')
                    == info.get('scene_token')):
                j = nj
            sweep_infos.append(self.infos[j])

        # one ida sample per CAMERA, shared across sweeps (the reference
        # samples ida once and reuses it for every sweep of that camera)
        ida_params = {}
        for cam in self.cams:
            rec = info['cam_infos'].get(cam)
            if rec is None:
                continue
            src_hw = rec.get('height', 900), rec.get('width', 1600)
            ida_params[cam] = self._sample_ida(rng, src_hw)

        sweeps_imgs, sweeps_s2e, sweeps_intr, sweeps_extr = [], [], [], []
        depth_grids = []
        for si, sinfo in enumerate(sweep_infos):
            imgs, s2e, intr, extr = [], [], [], []
            for cam in self.cams:
                rec = sinfo['cam_infos'].get(cam) or info['cam_infos'].get(cam)
                # a camera present only in an older sweep has no ida sample
                # (and would make per-sweep camera counts diverge): skip it
                # everywhere, consistently with the key frame
                if cam not in ida_params:
                    continue
                if rec is None:
                    continue
                calib = rec['calibrated_sensor']
                cam2own_ego = np.eye(4)
                cam2own_ego[:3, :3] = _quat_to_mat(calib['rotation'])
                cam2own_ego[:3, 3] = calib['translation']
                # camera -> its ego(t_cam) -> global -> reference ego(t_ref):
                # older sweeps land in the KEY frame's ego automatically
                sensor2ego = (ref_ego_inv @ _pose_to_mat(rec['ego_pose'])
                              @ cam2own_ego)

                k = np.asarray(calib['camera_intrinsic'], np.float64)
                resize, crop, flip = ida_params[cam]
                img = self._load_image(rec['filename'], resize, crop, flip)
                ida = self._ida_mat(resize, crop, flip, cfg.final_dim[1])
                k4 = np.eye(4)
                k4[:3, :3] = k
                k4 = ida @ k4  # fold augmentation into the intrinsic

                imgs.append(np.ascontiguousarray(img, np.uint8))
                s2e.append(sensor2ego.astype(np.float32))
                extr.append(np.linalg.inv(sensor2ego).astype(np.float32))
                intr.append(k4.astype(np.float32))
                # gate on the sweep INDEX, not identity: a scene-initial
                # frame repeats `info` for its missing predecessor, and an
                # identity gate would emit each camera's grid twice
                if cfg.depth_gt_root and si == 0:
                    # precomputed (u, v, depth) bins, mapped through THIS
                    # sample's ida and rasterized — the reference's
                    # depth_transform path (nusc_mv_det_dataset.py:387-396)
                    depth_grids.append(self._load_depth_gt(
                        rec['filename'], resize, crop, flip))
            sweeps_imgs.append(imgs)
            sweeps_s2e.append(s2e)
            sweeps_intr.append(intr)
            sweeps_extr.append(extr)
        imgs, s2e, intr, extr = (sweeps_imgs[0], sweeps_s2e[0],
                                 sweeps_intr[0], sweeps_extr[0])

        # ------------------------------------------------------------ boxes
        ego = ref_ego
        rows = []
        for ann in info.get('ann_infos', []):
            name = ann['category_name']
            cls = next((i for i, c in enumerate(self.classes) if c in name),
                       None)
            if cls is None:
                continue
            center = np.asarray(ann['translation'], np.float64)
            wlh = np.asarray(ann['size'], np.float64)
            yaw_global = Rotation.from_matrix(
                _quat_to_mat(ann['rotation'])).as_euler('zyx')[0]
            # global -> ego frame
            inv = np.linalg.inv(ego)
            c_ego = inv[:3, :3] @ center + inv[:3, 3]
            yaw = yaw_global + Rotation.from_matrix(inv[:3, :3]).as_euler('zyx')[0]
            vel = np.asarray(ann.get('velocity', [0, 0, 0]), np.float64)[:2]
            v_ego = (inv[:3, :3] @ np.array([vel[0], vel[1], 0.0]))[:2]
            rows.append([c_ego[0], c_ego[1], c_ego[2], wlh[1], wlh[0], wlh[2],
                         yaw, v_ego[0], v_ego[1], cls])
        obj = (np.asarray(rows, np.float32) if rows
               else np.zeros((0, 10), np.float32))

        # ---------------------------------------------------------- bda
        rot, scale, fdx, fdy = sample_bda(rng, cfg.bda_aug_conf, self.is_train)
        boxes, bda_rot = bda_transform(obj, rot, scale, fdx, fdy)
        bda_mat = np.eye(4, dtype=np.float32)
        bda_mat[:3, :3] = bda_rot

        k_cap = cfg.max_objs
        gt_boxes = np.zeros((k_cap, 9), np.float32)
        gt_labels = np.zeros((k_cap,), np.int32)
        gt_mask = np.zeros((k_cap,), bool)
        k = min(len(boxes), k_cap)
        if k:
            gt_boxes[:k] = boxes[:k, :9]
            gt_labels[:k] = boxes[:k, 9].astype(np.int32)
            gt_mask[:k] = True

        # real lidar points (key frame + sweeps), BDA-rotated like the
        # aiMotive host pipeline (aimotive_dataset.py:152) — the train step
        # un-rotates before projecting depth labels
        raw_pts = self._load_lidar_points(info, rng)
        n_feat = 8 if cfg.use_radar else 5
        points = np.zeros((cfg.max_points, n_feat), np.float32)
        point_mask = np.zeros((cfg.max_points,), bool)
        p = min(len(raw_pts), cfg.max_points)
        if p:
            pts = raw_pts[:p].copy()
            pts[:, :3] = pts[:, :3] @ bda_rot.T
            points[:p] = pts
            point_mask[:p] = True

        sample = {
            'points': points,
            'point_mask': point_mask,
            'gt_boxes': gt_boxes, 'gt_labels': gt_labels, 'gt_mask': gt_mask,
            'bda_mat': bda_mat,
            'cam_ts': np.float32(0.0),
            'imgs': (np.stack([np.stack(s) for s in sweeps_imgs])
                     if imgs else np.zeros((1, 1, 1, 1, 3), np.uint8)),
            'sensor2ego': (np.stack([np.stack(s) for s in sweeps_s2e])
                           if s2e else np.eye(4, dtype=np.float32)[None, None]),
            'intrin': (np.stack([np.stack(s) for s in sweeps_intr])
                       if intr else np.eye(4, dtype=np.float32)[None, None]),
            'extrinsics': (np.stack([np.stack(s) for s in sweeps_extr])
                           if extr else np.eye(4, dtype=np.float32)[None, None]),
            'path': info.get('sample_token', str(index)),
        }
        if cfg.depth_gt_root and depth_grids:
            sample['depth_gt'] = np.stack(depth_grids)  # [N, fh, fw]
        return sample
