"""Checkpoint import and export of the port (``models/torch_import.py``,
``models/torch_export.py``, ``scripts/import_checkpoint.py``,
``exps/parity.py``) against the JAX package's: the spconv SparseEncoder's
keys, a reference-format checkpoint built as the JAX tests build it
(``tests/test_data/test_import_checkpoint.py::_reference_ckpt``), the
export -> import round trip, a torchvision backbone as ``pretrained``, and
BN folding with the sparse encoder's BNs passing through. The cases the
reference keeps ``slow`` (the import's predict against JAX's, the
import-script-to-trainer run, the runbook end to end) are ``slow`` here."""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import jax

import mm_training_tpu.configs as jcfg
from mm_training_tpu.models import torch_import as j_ti
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.data import make_fake_batch
from mm_training_tpu_torch.exps.parity import find_checkpoint
from mm_training_tpu_torch.models import BEVDepthLiDAR
from mm_training_tpu_torch.models import torch_export as te
from mm_training_tpu_torch.models import torch_import as ti
from mm_training_tpu_torch.models.bn_fold import (BatchNorm2d, FoldedBN, MaskedBatchNorm2d,
                                                  conv_bn_pairs, fold_model)
from mm_training_tpu_torch.models.sparse_encoder import SparseEncoder
from mm_training_tpu_torch.models.weights import resnet_state_dict
from mm_training_tpu_torch.training import make_predict_step
from tests.test_data.test_import_checkpoint import _reference_ckpt
from tests.test_models.test_sparse_encoder import CHANNELS, _make_state_dict


@dataclasses.dataclass
class LightningHparams:
    """An object besides the tensors, as Lightning checkpoints carry."""
    lr: float


def _cfgs(variant='sparse_import', use_cam=True):
    """The JAX and the port's tiny L+R(+C) config with the LiDAR
    ``variant`` and a point cap of 8 (the JAX import tests' geometry)."""
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.tiny_test_config(use_cam=use_cam, use_lidar=True, use_radar=True)
        out.append(cfg.replace(lidar_conf=mod.LidarEncoderConf(
            variant=variant, voxelization=mod.VoxelizationConf(max_num_points=8,
                                                               max_voxels=1024))))
    return out


def test_convert_sparse_encoder_consumes_every_key():
    """Every SparseEncoder key of a reference state dict converts (JAX
    ``test_all_keys_consumed``): the port's state dict is as long as the
    source, loads strictly, and each z-slice kernel is the JAX converter's
    kernel, OIHW."""
    sd = _make_state_dict(np.random.default_rng(3))
    out = ti.convert_sparse_encoder({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                                    CHANNELS)
    assert len(out) == len(sd)
    SparseEncoder(tcfg.LidarEncoderConf()).double().load_state_dict(out)
    params, _ = j_ti.convert_sparse_encoder(sd, CHANNELS)
    n = 0
    for path, kernel in jax.tree_util.tree_leaves_with_path(params):
        if path[-1].key != 'kernel':
            continue
        scope = path[0].key
        sub = [p.key for p in path[1:-1]]
        n += 1
        name = {'conv_input': 'conv_input.0', 'conv_out': 'conv_out.0'}.get(scope)
        if name is None:
            si, rest = int(scope[5]), scope.split('_', 1)[1]
            stage = CHANNELS[si]
            j = len(stage) - 1 if rest == 'down' else int(rest[len('block'):])
            name = f'encoder_layers.encoder_layer{si + 1}.{j}' + (
                '.0' if rest == 'down' else f'.{sub[0]}')
        np.testing.assert_array_equal(out[f'{name}.weight'].numpy(),
                                      np.asarray(kernel).transpose(3, 2, 0, 1))
    assert n == 21


@pytest.mark.parametrize('variant', ['sparse_import', 'dense'])
def test_reference_checkpoint_imports_with_nothing_unrecognized(tmp_path, variant):
    """A reference-format L+R+C checkpoint with the spconv keys: zero
    unrecognized keys; with ``sparse_import`` zero skipped LiDAR keys and
    every entry of the port model given, with the dense encoder the 126
    SparseEncoder keys skipped (its LiDAR branch keeps the init)."""
    jc, tc = _cfgs(variant)
    path = _reference_ckpt(tmp_path, jc, with_lidar=True)
    model = BEVDepthLiDAR(tc, device='cpu')
    out, report = ti.convert_reference_checkpoint(ti.load_reference_state_dict(path), model)
    assert report['unrecognized_keys'] == [] and report['source_keys'] == 666
    if variant == 'sparse_import':
        assert report['skipped_lidar_encoder_keys'] == 0
        assert report['lidar_encoder'] == 'converted (sparse_import)'
        assert set(out) == set(model.state_dict())
    else:
        assert report['skipped_lidar_encoder_keys'] == 126
        assert not any(k.startswith('lidar_encoder.') for k in out)
    ti.merge_state_dict(model, out)
    with pytest.raises(ValueError, match='match no entry'):
        ti.convert_reference_checkpoint(dict(ti.load_reference_state_dict(path),
                                             **{'head.nope.weight': torch.zeros(1)}), model)


def _randomized(model, seed=7):
    """Every floating entry of ``model`` random (BN statistics too), but the
    DCN's bias, which the reference's mmcv DCN does not have: the export
    folds it into the 1x1 conv after it."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not t.is_floating_point() or name.endswith('depth_conv.4.bias'):
                continue
            if name.endswith('running_var'):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            else:
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return model


@pytest.mark.parametrize('variant', ['sparse_import', 'dense'])
def test_export_import_roundtrip_bitexact(tmp_path, variant):
    """Port state -> reference format (the spconv kernels re-expanded with
    zeros at the other taps, ``model.`` keys, the dead ``context_se``) ->
    file -> import: every entry equal bit for bit (JAX
    ``test_export_import_roundtrip_bitexact``); the dense LiDAR encoder is
    left out of the export."""
    _, tc = _cfgs(variant)
    model = _randomized(BEVDepthLiDAR(tc, device='cpu'))
    sd = te.export_reference_checkpoint(model.state_dict(), tc)
    assert all(k.startswith('model.') for k in sd)
    assert 'model.backbone.depth_net.context_se.conv_reduce.weight' in sd
    if variant == 'sparse_import':
        w = sd['model.lidar_encoder.pts_middle_encoder.encoder_layers.encoder_layer3.2.0.weight']
        assert w.shape == (3, 3, 3, 64, 128) and w[1:].abs().max() == 0   # tap kd = 0
        w = sd['model.lidar_encoder.pts_middle_encoder.conv_input.0.weight']
        assert w[0].abs().max() == 0 and w[2].abs().max() == 0 and w[1].abs().max() > 0
    path = str(tmp_path / 'export.ckpt')
    te.save_torch_checkpoint(path, sd)
    out, report = ti.convert_reference_checkpoint(ti.load_reference_state_dict(path), model)
    assert report['unrecognized_keys'] == [] and report['skipped_dead_context_se_keys'] == 4
    own = model.state_dict()
    want = {k for k in own if variant == 'sparse_import' or not k.startswith('lidar_encoder.')}
    assert set(out) == want
    for k in want:
        assert torch.equal(out[k], own[k]), k


def test_import_folds_a_conv_bias_into_the_bn_running_mean():
    """A checkpoint whose SeparateHead branch conv carries a bias (the port's
    conv has none) loads with the bias folded into the following BN's
    running mean, as the JAX ``_fold_bias_into_bn`` does."""
    _, tc = _cfgs('dense', use_cam=False)
    model = _randomized(BEVDepthLiDAR(tc, device='cpu'))
    sd = {k: v.clone() for k, v in model.state_dict().items()
          if not k.startswith('lidar_encoder.')}
    bias = torch.randn(64)
    sd['head.task_heads.0.reg.0.conv.bias'] = bias
    out, report = ti.convert_reference_checkpoint(sd, model)
    assert report['folded_conv_biases'] == 1
    mean = 'head.task_heads.0.reg.0.bn.running_mean'
    assert torch.equal(out[mean], model.state_dict()[mean] - bias)


def test_load_reference_state_dict_strips_wrappers_and_reads_lightning_extras(tmp_path):
    """Prefixes every key shares are stripped (``backbone.`` inside a full
    checkpoint is kept); a Lightning file with objects besides the tensors,
    which ``weights_only=True`` refuses, is read after a warning."""
    path = tmp_path / 'a.ckpt'
    torch.save({'state_dict': {'model.backbone.x': torch.ones(2), 'model.head.y': torch.ones(1)},
                'hyper_parameters': {'conf': LightningHparams(1)}}, path)
    with pytest.warns(UserWarning, match='weights_only=False'):
        sd = ti.load_reference_state_dict(str(path))
    assert set(sd) == {'backbone.x', 'head.y'}
    torch.save({'module.backbone.conv1.weight': torch.ones(1)}, tmp_path / 'b.pth')
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert set(ti.load_reference_state_dict(str(tmp_path / 'b.pth'))) == {'conv1.weight'}


def test_torchvision_resnet_merges_as_pretrained(tmp_path):
    """A torchvision-format ResNet-18 state dict (with its ``fc``) written to
    a file and named by ``ImageBackboneConf.pretrained``: ``init_state``
    merges it into the image backbone after the optimizer and the EMA
    shadow are made, as the JAX trainer does (the shadow keeps the random
    init, the optimizer steps the merged tensors); the same dict through the JAX ``convert_torchvision_
    resnet`` (its space-to-depth stem) carried into the port's names is
    the same tensors."""
    from mm_training_tpu_torch.training.trainer import Trainer
    _, tc = _cfgs('dense')
    gen = torch.Generator().manual_seed(0)
    own = BEVDepthLiDAR(tc, device='cpu').backbone.img_backbone.state_dict()
    tv = {k: (v if not v.is_floating_point()
              else 0.5 + torch.rand(v.shape, generator=gen) if k.endswith('running_var')
              else torch.randn(v.shape, generator=gen)) for k, v in own.items()}
    tv['fc.weight'], tv['fc.bias'] = torch.zeros(1000, 512), torch.zeros(1000)
    path = tmp_path / 'resnet18.pth'
    torch.save(tv, path)
    bb = tc.get_backbone_conf()
    cfg = tc.replace(use_ema=True, out_path=str(tmp_path / 'o'), backbone_conf=dataclasses.replace(
        bb, img_backbone_conf=dataclasses.replace(bb.img_backbone_conf, pretrained=str(path))))
    tr = Trainer(cfg, device='cpu')
    tr.setup(steps_per_epoch=1)
    state = tr.init_state(make_fake_batch(cfg, seed=0))
    got = state.model.backbone.img_backbone.state_dict()
    for k, v in got.items():
        assert torch.equal(v, tv[k]), k
        assert torch.equal(state.ema[f'backbone.img_backbone.{k}'], own[k]), k
    params = {id(p) for p in state.optimizer.params}
    assert all(id(p) in params for p in state.model.backbone.img_backbone.parameters())
    tr.close()
    p, s = j_ti.convert_torchvision_resnet({k: v.numpy() for k, v in tv.items()}, depth=18,
                                           stem_s2d=True)
    carried = resnet_state_dict(p, s, 4, depth=18, stem_s2d=True)
    for k, v in carried.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(v, tv[k]), k


def test_fold_passes_the_sparse_encoders_bns_through():
    """``fold_model`` on a ``sparse_import`` model folds the head's BNs and
    leaves every masked BN of the sparse encoder, with its statistics and
    eps 1e-3 (JAX ``test_sparse_encoder_stats_pass_through``); the folded
    model's predict keeps the unfolded boxes (fp32: scores within 2e-3)."""
    _, tc = _cfgs('sparse_import', use_cam=False)
    model = _randomized(BEVDepthLiDAR(tc, device='cpu'))
    batch = make_fake_batch(tc, seed=1)
    want = [a.numpy() for a in make_predict_step(tc, model)(batch)]
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith('lidar_encoder.')}
    pairs = fold_model(model)
    assert pairs and not any(bn.startswith('lidar_encoder.') for _, bn, _, _ in pairs)
    masked = [m for m in model.modules() if isinstance(m, MaskedBatchNorm2d)]
    assert len(masked) == 21 and all(m.eps == 1e-3 for m in masked)
    assert not any(type(m) is BatchNorm2d for m in model.modules())
    assert any(isinstance(m, FoldedBN) for m in model.modules())
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert conv_bn_pairs(model) == []
    gb, gs, gl, gv = (a.numpy() for a in make_predict_step(tc, model)(batch))
    np.testing.assert_array_equal(gv, want[3])
    np.testing.assert_allclose(gs[gv], want[1][want[3]], atol=2e-3)


def test_find_checkpoint_maps_stems_to_variants(tmp_path):
    """The runbook's file-name rules (JAX ``test_parity_runbook.py``): the
    longest matching stem wins; other files are ignored."""
    d = tmp_path / 'ckpts'
    d.mkdir()
    for name in ('lidar.ckpt', 'lidar_camera.ckpt', 'lidar_radar-v2.pth',
                 'lidar_cam_radar_epoch23.ckpt', 'readme.txt'):
        (d / name).write_bytes(b'x')
    assert find_checkpoint(str(d), 'lidar_only').endswith('lidar.ckpt')
    assert find_checkpoint(str(d), 'lidar_cam').endswith('lidar_camera.ckpt')
    assert find_checkpoint(str(d), 'lidar_radar').endswith('lidar_radar-v2.pth')
    assert find_checkpoint(str(d), 'lidar_cam_radar').endswith('lidar_cam_radar_epoch23.ckpt')


@pytest.mark.slow
def test_import_checkpoint_predict_matches_jax_import(tmp_path):
    """The same reference-format L+R+C file imported by both packages
    (JAX: ``load_torch_state_dict``, ``convert_reference_checkpoint``,
    ``merge_subtree``, as its ``import_checkpoint`` does) predicts the same
    boxes: valid flags and labels equal, scores within 1e-4, boxes within
    1e-3."""
    import jax.numpy as jnp

    from mm_training_tpu.data.fake_batch import make_fake_batch as j_fake_batch
    from mm_training_tpu.models import BEVDepthLiDAR as JModel
    from mm_training_tpu.training.train_step import TrainState
    from mm_training_tpu.training.train_step import make_predict_step as j_predict
    jc, tc = _cfgs('sparse_import')
    path = _reference_ckpt(tmp_path, jc, with_lidar=True)
    jm = JModel(jc)
    jbatch = j_fake_batch(jc, seed=3)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    variables = jax.jit(jm.init, static_argnums=(3,))(
        jax.random.PRNGKey(0), dict(jb, flipped=jnp.zeros((2 * jc.num_cameras,), bool)),
        None, False)
    params, stats = j_ti.convert_reference_checkpoint(j_ti.load_torch_state_dict(path), jc)
    merged = j_ti.merge_subtree(variables, params, stats)
    want = [np.asarray(a) for a in j_predict(jc, jm)(
        TrainState(step=jnp.zeros((), jnp.int32), params=merged['params'],
                   batch_stats=merged['batch_stats'], opt_state=None), jb)]
    model = BEVDepthLiDAR(tc, device='cpu')
    out, _ = ti.convert_reference_checkpoint(ti.load_reference_state_dict(path), model)
    ti.merge_state_dict(model, out)
    (gb, gs, gl, gv), (wb, ws, wl, wv) = ([a.numpy() for a in make_predict_step(tc, model)(
        make_fake_batch(tc, seed=3))], want)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() > 20
    np.testing.assert_array_equal(gl[wv], wl[wv])
    np.testing.assert_allclose(gs, ws, atol=1e-4)
    for b, i in zip(*np.nonzero(wv)):
        same = gv[b] & (gl[b] == wl[b, i]) & (np.abs(gs[b] - ws[b, i]) <= 1e-4)
        assert np.abs(gb[b, same] - wb[b, i]).max(-1).min() <= 1e-3, (b, i)


@pytest.mark.slow
def test_import_checkpoint_script_writes_what_the_trainer_restores(tmp_path, capsys):
    """``python -m mm_training_tpu_torch.scripts.import_checkpoint CKPT``
    on the CPU: the coverage report (zero unrecognized and skipped LiDAR
    keys, the smoke predict finite), and ``<out>/0/state.pt`` restored by a
    Trainer through ``ckpt_path`` with the imported weights."""
    from mm_training_tpu_torch.models.torch_import import load_reference_state_dict
    from mm_training_tpu_torch.scripts import import_checkpoint
    from mm_training_tpu_torch.training.trainer import Trainer
    jc, tc = _cfgs('sparse_import')
    path = _reference_ckpt(tmp_path, jc, with_lidar=True)
    out = tmp_path / 'converted'
    report = import_checkpoint.main([path, '--config', 'tiny_test_config', '--device', 'cpu',
                                     '--out', str(out), 'use_cam=True'])
    printed = json.loads(capsys.readouterr().out.split('\n', 1)[1])
    assert printed == json.loads(json.dumps(report))
    assert report['forward_smoke'] == 'ok' and report['unrecognized_keys'] == []
    assert report['skipped_lidar_encoder_keys'] == 0 and (out / '0' / 'state.pt').is_file()
    cfg = tc.replace(ckpt_path=str(out), out_path=str(tmp_path / 'o'))
    tr = Trainer(cfg, device='cpu')
    tr.setup(steps_per_epoch=1)
    state = tr.init_state(make_fake_batch(cfg, seed=0))
    src = load_reference_state_dict(path)
    name = 'lidar_encoder.pts_middle_encoder.encoder_layers.encoder_layer2.1.bn2.running_mean'
    assert state.step == 0 and torch.equal(state.model.state_dict()[name], src[name].float())
    tr.close()


@pytest.mark.slow
def test_parity_runbook_end_to_end(tmp_path):
    """``exps.parity`` on a written tree (two ODDs) with one reference-format
    checkpoint: the variant converted and evaluated per ODD, a variant
    without a checkpoint reported and skipped, both reports written (JAX
    ``test_parity_runbook_end_to_end``)."""
    from mm_training_tpu.data.synthetic import generate_synthetic_dataset
    from mm_training_tpu_torch.exps.parity import run_parity

    root = generate_synthetic_dataset(str(tmp_path / 'ds'), splits=('val',),
                                      odds=('highway', 'urban'), sequences_per_odd=1,
                                      frames_per_sequence=2, img_hw=(64, 128))
    jc, _ = _cfgs('sparse_import')
    ckpt_dir = tmp_path / 'ckpts'
    ckpt_dir.mkdir()
    (ckpt_dir / 'lidar_cam_radar.ckpt').write_bytes(
        open(_reference_ckpt(tmp_path, jc, with_lidar=True), 'rb').read())
    paper = tmp_path / 'paper.json'
    paper.write_text(json.dumps({'lidar_cam_radar': {'highway': 0.5, 'urban': 0.4}}))

    def factory(variant, **kw):
        cfg = tcfg.tiny_test_config(use_cam=True, use_lidar=True, use_radar=True,
                                    batch_size=1, num_workers=1, **kw)
        return cfg.replace(lidar_conf=tcfg.LidarEncoderConf(
            variant='sparse_import', voxelization=tcfg.VoxelizationConf(max_num_points=8)))
    report = run_parity(root, str(ckpt_dir), out=str(tmp_path / 'parity_out'),
                        variants=('lidar_cam_radar', 'lidar_only'), odds=('highway', 'urban'),
                        paper_json=str(paper), cfg_factory=factory, device='cpu')
    res = report['results']
    assert 'error' in res['lidar_only']
    lrc = res['lidar_cam_radar']
    assert lrc['import_report']['skipped_lidar_encoder_keys'] == 0
    assert set(lrc['per_odd']) == {'highway', 'urban'}
    for odd, m in lrc['per_odd'].items():
        assert np.isfinite(m[f'test_{odd}_detection_loss'])
    md = (tmp_path / 'parity_out' / 'parity_report.md').read_text()
    assert '| lidar_cam_radar | highway |' in md and '0.500' in md
    assert (tmp_path / 'parity_out' / 'parity_report.json').is_file()
