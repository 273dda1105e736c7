"""Config surface of the PyTorch port.

The port's own copy of ``mm_training_tpu/configs/base.py``: the same frozen
dataclasses, knob names, defaults and derived values, cut to what the
port's modules read: the predict, train and eval steps, the camera branch's
sub-configs (``BackboneConf`` and friends, :27-97 there), the data
pipeline, the trainer and its CLIs (:257-342 there).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ImageBackboneConf:
    """ResNet image backbone (reference conf_aim.py:53-61). ``stem_s2d``:
    the JAX package runs the stem as its exact space-to-depth form and
    stores the [4, 4, 12, 64] kernel; the port carries it across as the
    reference's 7x7/2 ``conv1`` (``models/weights.py``)."""
    depth: int = 50
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    # a torchvision-format ResNet state dict (.pth) the trainer merges into
    # the image backbone at init (conf_aim.py:60's ImageNet init), or None
    pretrained: Optional[str] = None
    stem_s2d: bool = True


@dataclass(frozen=True)
class ImageNeckConf:
    """SECONDFPN image neck (reference conf_aim.py:62-68)."""
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    upsample_strides: Tuple[float, ...] = (0.25, 0.5, 1, 2)
    out_channels: Tuple[int, ...] = (128, 128, 128, 128)


@dataclass(frozen=True)
class DepthNetConf:
    """DepthNet (reference conf_aim.py:69-70, lss_fpn.py:160-248)."""
    in_channels: int = 512
    mid_channels: int = 512
    use_dcn: bool = True      # deformable conv in the depth branch (kernel K5)
    num_blocks: int = 3       # BasicBlocks in the depth branch
    # the JAX config's field, which nothing of either package reads
    aspp_mid_channels: int = -1  # -1 => mid_channels


@dataclass(frozen=True)
class BackboneConf:
    """Camera->BEV backbone (LSSFPN) config (reference conf_aim.py:42-71)."""
    x_bound: Tuple[float, float, float] = (-204.8, 204.8, 0.8)
    y_bound: Tuple[float, float, float] = (-25.6, 25.6, 0.8)
    z_bound: Tuple[float, float, float] = (-5.0, 3.0, 8.0)
    d_bound: Tuple[float, float, float] = (2.0, 206.4, 0.5)
    final_dim: Tuple[int, int] = (704, 1280)
    output_channels: int = 80
    downsample_factor: int = 16
    img_backbone_conf: ImageBackboneConf = field(default_factory=ImageBackboneConf)
    img_neck_conf: ImageNeckConf = field(default_factory=ImageNeckConf)
    depth_net_conf: DepthNetConf = field(default_factory=DepthNetConf)
    # extra BEV downsample at splat time, so the camera BEV lands on the
    # head-input grid (grid/8): 1.6 m cells for the default geometry
    bev_pool_downsample: int = 2
    # the row-factorized splat (kernel K4), exact for the virtualized
    # zero-roll/pitch rig; False: the general splat (kernel K8) for raw rigs
    factorized_splat: bool = True

    @property
    def depth_channels(self) -> int:
        """Number of depth bins == len(arange(*d_bound))."""
        return int(math.ceil((self.d_bound[1] - self.d_bound[0]) / self.d_bound[2] - 1e-9))

    @property
    def feat_hw(self) -> Tuple[int, int]:
        return (self.final_dim[0] // self.downsample_factor,
                self.final_dim[1] // self.downsample_factor)

    @property
    def bev_hw(self) -> Tuple[int, int]:
        """Camera BEV (H=y, W=x) after splatting, on the head-input grid."""
        sx = self.x_bound[2] * self.bev_pool_downsample
        sy = self.y_bound[2] * self.bev_pool_downsample
        return (int(round((self.y_bound[1] - self.y_bound[0]) / sy)),
                int(round((self.x_bound[1] - self.x_bound[0]) / sx)))


@dataclass(frozen=True)
class BEVBackboneConf:
    """ResNet18-style BEV trunk (reference conf_aim.py:100-110)."""
    in_channels: int = 336
    base_channels: int = 160
    num_stages: int = 3
    strides: Tuple[int, ...] = (1, 2, 2)
    out_indices: Tuple[int, ...] = (0, 1, 2)


@dataclass(frozen=True)
class BEVNeckConf:
    """SECONDFPN BEV neck (reference conf_aim.py:112-115)."""
    in_channels: Tuple[int, ...] = (160, 320, 640)
    upsample_strides: Tuple[int, ...] = (8, 16, 32)
    out_channels: Tuple[int, ...] = (64, 64, 64)


@dataclass(frozen=True)
class TaskConf:
    num_class: int
    class_names: Tuple[str, ...]


@dataclass(frozen=True)
class BBoxCoderConf:
    """CenterPointBBoxCoder (reference conf_aim.py:138-148)."""
    post_center_range: Tuple[float, ...] = (-214.8, -35.6, -10, 214.8, 35.6, 10)
    max_num: int = 500
    score_threshold: float = 0.0
    out_size_factor: int = 4
    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 8.0)
    pc_range: Tuple[float, ...] = (-204.8, -25.6, -5, 204.8, 25.6, 3)
    code_size: int = 9


@dataclass(frozen=True)
class TrainCfg:
    """Target-generation config (reference conf_aim.py:150-161)."""
    point_cloud_range: Tuple[float, ...] = (-204.8, -25.6, -5, 204.8, 25.6, 3)
    grid_size: Tuple[int, int, int] = (2048, 256, 1)  # (x, y, z)
    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 8.0)
    out_size_factor: int = 4
    dense_reg: int = 1
    gaussian_overlap: float = 0.1
    max_objs: int = 500
    min_radius: int = 2
    code_weights: Tuple[float, ...] = (1.0,) * 8 + (0.0, 0.0)


@dataclass(frozen=True)
class TestCfg:
    """Decode/NMS config (reference conf_aim.py:163-175)."""
    post_center_limit_range: Tuple[float, ...] = (-204.8, -25.6, -5, 204.8, 25.6, 3)
    max_per_img: int = 500
    min_radius: Tuple[float, ...] = (4, 10, 0.5, 0.25)
    score_threshold: float = 0.1
    out_size_factor: int = 4
    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 8.0)
    nms_type: str = 'circle'
    pre_max_size: int = 1000
    post_max_size: int = 83
    nms_thr: float = 0.2


@dataclass(frozen=True)
class HeadConf:
    """BEVDepthHead config (reference conf_aim.py:177-190)."""
    bev_backbone_conf: BEVBackboneConf = field(default_factory=BEVBackboneConf)
    bev_neck_conf: BEVNeckConf = field(default_factory=BEVNeckConf)
    tasks: Tuple[TaskConf, ...] = (
        TaskConf(1, ('car',)),
        TaskConf(1, ('truck/bus',)),
        TaskConf(1, ('motorcycle',)),
        TaskConf(1, ('pedestrian',)),
    )
    common_heads: Tuple[Tuple[str, Tuple[int, int]], ...] = (
        ('reg', (2, 2)), ('height', (1, 2)), ('dim', (3, 2)),
        ('rot', (2, 2)), ('vel', (2, 2)),
    )
    bbox_coder: BBoxCoderConf = field(default_factory=BBoxCoderConf)
    train_cfg: TrainCfg = field(default_factory=TrainCfg)
    test_cfg: TestCfg = field(default_factory=TestCfg)
    in_channels: int = 192  # == sum(bev_neck.out_channels)
    init_bias: float = -2.19
    final_kernel: int = 3
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    loss_bbox_weight: float = 0.25


@dataclass(frozen=True)
class VoxelizationConf:
    """Hard voxelization (reference conf_aim.py:194-197)."""
    max_num_points: int = 15
    max_voxels: int = 25000
    num_features: int = 5  # HardSimpleVFE num_features (conf_aim.py:200)


@dataclass(frozen=True)
class LidarEncoderConf:
    """Dense pillar encoder standing in for the mmdet3d SparseEncoder
    (conf_aim.py:202-212): a 2D conv pyramid with the SparseEncoder's channel
    progression at total stride 8, ending in the 256-channel BEV contract.

    ``variant='sparse_import'``: the masked-dense replica of the reference's
    SparseEncoder (``models/sparse_encoder.py``), whose weights import from
    the released checkpoints (``models/torch_import.py``).
    """
    in_channels: int = 5
    encoder_channels: Tuple[Tuple[int, ...], ...] = (
        (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))
    out_channels: int = 256
    voxelization: VoxelizationConf = field(default_factory=VoxelizationConf)
    variant: str = 'dense'
    # fold 2x2 pillar blocks into channels before the conv pyramid; the /8
    # BEV output contract is unchanged (strides move inward one stage)
    space_to_depth: bool = True


@dataclass(frozen=True)
class BDAAugConf:
    """BEV data augmentation (reference conf_aim.py:93-98)."""
    rot_lim: Tuple[float, float] = (-5.0, 5.0)
    scale_lim: Tuple[float, float] = (0.95, 1.05)
    flip_dx_ratio: float = 0.5
    flip_dy_ratio: float = 0.5


CLASSES: Tuple[str, ...] = ('car', 'truck/bus', 'motorcycle', 'pedestrian', 'other')

# aiMotive annotation type -> class id (reference dataset/src/aimotive_dataset.py:14-21)
CATEGORY_MAPPING = {
    'CAR': 0, 'Size_vehicle_m': 0,
    'TRUCK': 1, 'BUS': 1, 'TRUCK/BUS': 1, 'TRAIN': 1, 'Size_vehicle_xl': 1,
    'VAN': 1, 'PICKUP': 1, 'TRAILER': 1,
    'MOTORCYCLE': 2, 'RIDER': 2, 'BICYCLE': 2, 'BIKE': 2,
    'Two_wheel_without_rider': 2, 'Rider': 2,
    'OTHER_RIDEABLE': 2, 'OTHER-RIDEABLE': 2,
    'PEDESTRIAN': 3, 'BABY_CARRIAGE': 3,
    'SHOPPING-CART': 4, 'OTHER-OBJECT': 4,
}


@dataclass(frozen=True)
class Config:
    """Top-level experiment config — same knob names as exps/conf_aim.py."""
    # --- image / paths / run (conf_aim.py:1-14)
    H: int = 704
    W: int = 1280
    data_root: str = '/data/aimotive_dataset'
    eval_split: Optional[str] = None  # None | highway | urban | rain | night
    experiment_name: str = 'lidar_radar'
    precision: str = 'bf16'  # 'fp32' | 'bf16'
    batch_size: int = 1      # per-device batch size
    out_path: Optional[str] = None  # defaults to output/{experiment_name}
    log_wandb: bool = False
    num_workers: int = 8
    # 'thread' (numpy and the native codec release the GIL) or 'process'
    # (forked workers; training/loader.py)
    loader_worker_mode: str = 'thread'
    seed: int = 0
    base_learning_rate: float = 1e-3  # lr = base/64*global_batch (conf_aim.py:14)

    # --- BEV grid (conf_aim.py:16-18)
    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 8.0)
    out_size_factor: int = 4
    point_cloud_range: Tuple[float, ...] = (-204.8, -25.6, -5.0, 204.8, 25.6, 3.0)

    # --- modality switches (conf_aim.py:20-27)
    use_cam: bool = False
    use_lidar: bool = True
    use_radar: bool = True
    use_depth_loss: bool = True   # gates the depth-oracle input of the lift
    train_velocity: bool = False
    look_back: int = 0
    look_forward: int = 0
    ckpt_path: Optional[str] = None
    # root of a mirror tree of precomputed depth-GT grids (one
    # <frame>_depth.npy a keyframe, [N, H/16, W/16] min depths): the batches
    # carry them as 'depth_gt' and the train step bins them (kernel K6's
    # depth_grid_to_onehot) instead of projecting the points
    depth_gt_root: Optional[str] = None

    # --- trainer (conf_aim.py:29-32 + Lightning defaults, mm_training_aim.py:524-531,619-628)
    max_epochs: int = 999
    log_every_n_steps: int = 50
    # decode + log scene/heatmap/depth panels on the current train batch
    # every N steps (reference: wandb artifacts every 200 steps,
    # mm_training_aim.py:270-284). 0 = per-eval-epoch panels only.
    viz_every_n_steps: int = 0
    gradient_clip_val: float = 2.0
    weight_decay: float = 1e-7
    lr_milestones: Tuple[int, ...] = (19, 23)  # MultiStepLR epochs
    lr_gamma: float = 0.1
    early_stop_patience: int = 8
    save_top_k: int = 10
    latest_every_n_steps: int = 500
    # checkpoints: save() returns after the copy to host memory and a thread
    # writes the file; fit() and restore() wait for it
    async_checkpointing: bool = True
    num_sanity_val_steps: int = 2
    use_ema: bool = False     # reference defines EMA but leaves it unregistered
    ema_decay: float = 0.9999
    use_tta: bool = False     # 4-way flip ensemble at eval/predict (training/tta.py)
    # the (model, data) layout of the ranks (parallel/mesh.py::make_mesh):
    # model_parallel ranks hold W shards of the fused BEV through the head
    # (parallel/spatial.py); num_slices nodes lay the data axis out
    # node-major. Each is at least 1
    model_parallel: int = 1
    num_slices: int = 1
    # K train steps a group of stacked batches (training/train_step.py::
    # make_train_step_multi); trailing batches take the single step
    steps_per_dispatch: int = 1

    # --- fixed-shape capacities
    max_points_per_frame: int = 0   # 0 => (1+look_back+look_forward)*100_000
    max_objs: int = 500
    num_cameras: int = 4
    num_sweeps: int = 1
    # each Mei fisheye -> two yaw+-30deg virtual pinholes (data_loader.py:
    # 152-191); with both fisheyes on, set num_cameras=6. Off by default —
    # the reference also ships with fisheye imreads commented out.
    virtualize_fisheyes: bool = False

    backbone_conf: Optional[BackboneConf] = None
    head_conf: Optional[HeadConf] = None
    lidar_conf: Optional[LidarEncoderConf] = None
    bda_aug_conf: BDAAugConf = field(default_factory=BDAAugConf)

    def __post_init__(self):
        for knob in ('model_parallel', 'num_slices'):
            if getattr(self, knob) < 1:
                raise ValueError(f'{knob}={getattr(self, knob)}: the rank layout takes a '
                                 'count of at least 1')

    # ------------------------------------------------------------------ derived
    @property
    def final_dim(self) -> Tuple[int, int]:
        return (self.H, self.W)

    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate / 64 * self.batch_size

    @property
    def lidar_input_channels(self) -> int:
        return 8 if self.use_radar else 5

    @property
    def lidar_feature_channels(self) -> int:
        return 256 if self.use_lidar else 0

    @property
    def camera_feature_channels(self) -> int:
        """80 per sweep: the sweeps' BEVs are concatenated on channels."""
        return 80 * self.num_sweeps if self.use_cam else 0

    @property
    def fuse_layer_in_channels(self) -> int:
        return self.camera_feature_channels + self.lidar_feature_channels

    @property
    def out_shape(self) -> Tuple[int, int]:
        """(ny, nx) full-resolution BEV grid (conf_aim.py:39-40)."""
        pc = self.point_cloud_range
        # round(), not int(): 30.0/0.2 = 149.999... would lose a grid row
        return (int(round((pc[4] - pc[1]) / self.voxel_size[1])),
                int(round((pc[3] - pc[0]) / self.voxel_size[0])))

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        ny, nx = self.out_shape
        return (nx, ny, 1)

    @property
    def max_points(self) -> int:
        if self.max_points_per_frame:
            return self.max_points_per_frame
        return (1 + self.look_back + self.look_forward) * 100_000

    @property
    def depth_channels(self) -> int:
        return self.get_backbone_conf().depth_channels

    @property
    def output_path(self) -> str:
        return self.out_path or f'output/{self.experiment_name}'

    # -------------------------------------------------------------- sub-configs
    def get_backbone_conf(self) -> BackboneConf:
        if self.backbone_conf is not None:
            return self.backbone_conf
        pc, vs, osf = self.point_cloud_range, self.voxel_size, self.out_size_factor
        return BackboneConf(
            x_bound=(pc[0], pc[3], vs[0] * osf),
            y_bound=(pc[1], pc[4], vs[1] * osf),
            z_bound=(pc[2], pc[5], vs[2]),
            d_bound=(2.0, pc[3] + 1.6, 0.5),
            final_dim=self.final_dim,
            output_channels=80,    # per sweep (camera_feature_channels is the total)
        )

    def get_head_conf(self) -> HeadConf:
        if self.head_conf is not None:
            return self.head_conf
        pc, vs, osf = self.point_cloud_range, self.voxel_size, self.out_size_factor
        vel_w = 0.3 if self.train_velocity else 0.0
        return HeadConf(
            bev_backbone_conf=BEVBackboneConf(in_channels=self.fuse_layer_in_channels),
            bbox_coder=BBoxCoderConf(
                post_center_range=(pc[0] - 10.0, pc[1] - 10.0, -10,
                                   pc[3] + 10.0, pc[4] + 10.0, 10),
                out_size_factor=osf, voxel_size=vs, pc_range=pc,
            ),
            train_cfg=TrainCfg(
                point_cloud_range=pc, grid_size=self.grid_size, voxel_size=vs,
                out_size_factor=osf, max_objs=self.max_objs,
                code_weights=(1.0,) * 8 + (vel_w, vel_w),
            ),
            test_cfg=TestCfg(
                post_center_limit_range=pc, out_size_factor=osf, voxel_size=vs,
            ),
        )

    def get_lidar_conf(self) -> LidarEncoderConf:
        if self.lidar_conf is not None:
            return self.lidar_conf
        return LidarEncoderConf()

    def replace(self, **kw) -> 'Config':
        return dataclasses.replace(self, **kw)
