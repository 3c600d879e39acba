"""Export: the version directory's contract, the exporters and callbacks,
and the ``torch.export`` serving program, on the CPU.

Mirrors ``tests/test_export_serving.py``'s exporter cases on the port's
mock model, and adds the program's own pins: the tiny QT-Opt program holds
the pool and conv1 kernels as the custom ops ``t2r.pool_fwd`` (3) and
``t2r.conv_s2d_fwd`` (1) under ``kernel_policy='pool_conv'`` and none
under ``'none'``; the flash forward and the photometric pass export as
the custom ops ``t2r.flash_fwd`` and ``t2r.photometric``, one node each,
bit for bit the eager function; the program fingerprint ignores weights;
one artifact serves batch 1 and batch 5; and a process that cannot import
the model's modules loads and runs it. The assets' text format is read by
the JAX package's ``load_specs_from_export_dir`` and the port reads the
JAX package's.
"""

import functools
import json
import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch import nn
from torch_serving_fixtures import (  # one_thread: an autouse fixture
    export_predictor, mock_features, one_thread, qtopt_features, qtopt_model,
    qtopt_predictor, trained_mock, version_files)

from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu.specs import TensorSpec as JaxTensorSpec
from tensor2robot_tpu.specs import assets as jax_assets
from tensor2robot_tpu_torch import export as export_lib
from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.models.base import AbstractT2RModel
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.ops import flash_attention, photometric
from tensor2robot_tpu_torch.predictors import ExportedModelPredictor
from tensor2robot_tpu_torch.specs import SpecStruct, TensorSpec
from tensor2robot_tpu_torch.specs import assets as port_assets
from tensor2robot_tpu_torch.train import train_eval_model
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERSION_FILES = [
    'assets.extra/t2r_assets.json', 'assets.extra/t2r_assets.pbtxt',
    'assets.extra/warmup_requests.npz',
    'assets.extra/warmup_requests.tfexamples', 'export_commit.json',
    'export_meta.json', 'serving_fn.pt2', 'state/state.pt']
POOL = 't2r.pool_fwd.default'
CONV = 't2r.conv_s2d_fwd.default'
# The plain versions' ops (pads, compares, selects, im2col products) and the
# library pool: none may stand in for a kernel under 'pool_conv'.
PLAIN_OPS = ('aten.pad.default', 'aten.constant_pad_nd.default',
             'aten.gt.Tensor', 'aten.where.self', 'aten.mm.default',
             'aten.matmul.default', 'aten.max_pool2d.default',
             'aten.max_pool2d_with_indices.default')


class TestExporters:

  def test_model_exporter_writes_valid_version(self, tmp_path):
    trainer, model = trained_mock(tmp_path)
    root = str(tmp_path / 'export')
    path = export_lib.ModelExporter().export(model, trainer.state, root)
    assert export_lib.valid_export_dirs(root) == [path]
    feature_spec, _, global_step = port_assets.load_specs_from_export_dir(
        path)
    assert global_step == 5
    assert 'measured_position' in feature_spec
    assert version_files(path) == VERSION_FILES
    meta = exporters.read_export_meta(path)
    assert meta['self_contained_serving_fn'] is True
    assert meta['serving_fn'] == exporters.SERVING_FN_FILENAME
    assert meta['trace_device'] == 'cpu'
    assert meta['model_class'] == 'tensor2robot_tpu_torch.utils.mocks.MockT2RModel'

  def test_commit_marker_is_written_last(self, tmp_path, monkeypatch):
    """When the marker is written every other file of the version is
    complete, and the version is published only after it."""
    trainer, model = trained_mock(tmp_path)
    root = tmp_path / 'export'
    seen = {}
    write = exporters.ckpt_lib.write_durably
    replace = os.replace

    def recording_write(path, fn):
      if path.endswith(exporters.EXPORT_COMMIT_FILENAME):
        seen['before_marker'] = version_files(os.path.dirname(path))
      write(path, fn)

    def recording_replace(src, dst):
      if os.path.basename(src).startswith('.tmp_'):
        seen['published'] = version_files(src)
      replace(src, dst)

    monkeypatch.setattr(exporters.ckpt_lib, 'write_durably', recording_write)
    monkeypatch.setattr(exporters.os, 'replace', recording_replace)
    path = export_lib.ModelExporter().export(model, trainer.state, str(root))
    others = [f for f in VERSION_FILES if f != 'export_commit.json']
    assert seen['before_marker'] == others
    assert seen['published'] == VERSION_FILES
    assert os.path.basename(path).isdigit()
    assert not [e for e in os.listdir(root) if e.startswith('.tmp_')]

  def test_torn_version_is_skipped_and_counted_once(self, tmp_path):
    trainer, model = trained_mock(tmp_path)
    root = str(tmp_path / 'export')
    exporter = export_lib.ModelExporter()
    good = exporter.export(model, trainer.state, root, version=1)
    torn = exporter.export(model, trainer.state, root, version=2)
    os.remove(os.path.join(torn, exporters.EXPORT_COMMIT_FILENAME))
    counter = metrics_lib.counter('export/uncommitted_skipped')
    before = counter.value
    assert exporters.committed_export_dirs(root) == [good]
    assert exporters.committed_export_dirs(root) == [good]
    assert counter.value == before + 1
    predictor = ExportedModelPredictor(root, device='cpu')
    assert predictor.restore() and predictor.model_path == good

  def test_gc_keeps_newest(self, tmp_path):
    trainer, model = trained_mock(tmp_path)
    root = str(tmp_path / 'export')
    exporter = export_lib.ModelExporter(keep=2, serialize_serving=False)
    paths = [exporter.export(model, trainer.state, root, version=v)
             for v in (1, 2, 3, 4)]
    assert export_lib.valid_export_dirs(root) == paths[-2:]

  def test_export_state_merges_and_survives_corruption(self, tmp_path):
    root = str(tmp_path / 'export')
    assert exporters.read_export_state(root) == {}
    exporters.write_export_state(root, last_exported_step=3)
    exporters.write_export_state(root, best_metrics={'loss': 0.5})
    assert exporters.read_export_state(root) == {
        'last_exported_step': 3, 'best_metrics': {'loss': 0.5}}
    with open(os.path.join(root, exporters.EXPORT_STATE_FILENAME), 'w') as f:
      f.write('{not json')
    assert exporters.read_export_state(root) == {}

  def test_serving_downgrade_warns_loudly(self, tmp_path, caplog):
    trainer, model = trained_mock(tmp_path)

    def broken_network(*args, **kwargs):
      raise RuntimeError('symbolic trace unsupported here')

    model.inference_network_fn = broken_network
    root = str(tmp_path / 'export')
    with caplog.at_level(logging.WARNING):
      path = export_lib.ModelExporter().export(model, trainer.state, root)
    assert any('self-contained torch.export serving export failed'
               in r.message.lower() for r in caplog.records)
    meta = exporters.read_export_meta(path)
    assert meta['self_contained_serving_fn'] is False
    assert not os.path.exists(os.path.join(path, 'serving_fn.pt2'))

  def test_saved_model_is_not_ported(self):
    with pytest.raises(NotImplementedError, match='SavedModel'):
      export_lib.ModelExporter(saved_model=True)

  def test_best_exporter_only_improves(self, tmp_path):
    trainer, _ = trained_mock(tmp_path)
    exporter = export_lib.BestExporter(
        compare_fn=export_lib.create_valid_result_smaller('loss'))
    assert exporter.export(trainer, {'loss': 1.0}) is not None
    assert exporter.export(trainer, {'loss': 2.0}) is None  # worse
    assert exporter.export(trainer, {'loss': 0.5}) is not None
    # A restarted run keeps the persisted bar.
    restarted = export_lib.BestExporter()
    assert restarted.export(trainer, {'loss': 0.7}) is None
    assert restarted.export(trainer, {'loss': 0.4}) is not None
    larger = export_lib.create_valid_result_larger('acc')
    assert larger(None, {'acc': 0.1}) and larger({'acc': 0.1}, {'acc': 0.2})
    assert not larger({'acc': 0.2}, {'acc': 0.1})

  def test_latest_exporter_skips_already_exported_steps(self, tmp_path):
    trainer, _ = trained_mock(tmp_path)
    exporter = export_lib.LatestExporter()
    assert exporter.export(trainer, {}) is not None
    assert export_lib.LatestExporter().export(trainer, {}) is None

  def test_async_export_callback(self, tmp_path):
    callback = export_lib.AsyncExportCallback()
    trainer, _ = trained_mock(tmp_path, steps=4, callbacks=[callback],
                              save_interval_steps=2)
    callback.join()
    root = os.path.join(trainer.config.model_dir, 'export',
                        'latest_exporter_numpy')
    assert len(export_lib.valid_export_dirs(root)) >= 1
    assert exporters.read_export_state(root)['last_exported_step'] == 4
    predictor = ExportedModelPredictor(root, device='cpu')
    assert predictor.restore() and predictor.global_step == 4

  def test_td3_lagged_export(self, tmp_path):
    export_dir = str(tmp_path / 'export')
    lagged_dir = str(tmp_path / 'lagged')
    callback = export_lib.TD3ExportCallback(export_dir, lagged_dir)
    trained_mock(tmp_path, steps=4, callbacks=[callback],
                 save_interval_steps=2)
    current = export_lib.valid_export_dirs(export_dir)
    lagged = export_lib.valid_export_dirs(lagged_dir)
    assert current and lagged
    _, _, current_step = port_assets.load_specs_from_export_dir(current[-1])
    _, _, lagged_step = port_assets.load_specs_from_export_dir(lagged[-1])
    assert lagged_step < current_step  # one version behind

  def test_train_eval_model_runs_the_default_exporters(self, tmp_path):
    model = MockT2RModel()
    model_dir = str(tmp_path / 'm')
    train_gen = MockInputGenerator(batch_size=8)
    eval_gen = MockInputGenerator(batch_size=8)
    metrics = train_eval_model(
        model=model, model_dir=model_dir, train_input_generator=train_gen,
        eval_input_generator=eval_gen, max_train_steps=4, eval_steps=2,
        eval_interval_steps=4, save_interval_steps=4, log_interval_steps=0,
        create_exporters_fn=export_lib.create_default_exporters(),
        device='cpu')
    assert 'loss' in metrics
    for name in ('best_exporter_numpy', 'latest_exporter_numpy'):
      root = os.path.join(model_dir, 'export', name)
      (path,) = export_lib.valid_export_dirs(root)
      assert exporters.read_export_meta(path)['global_step'] == 4
      predictor = ExportedModelPredictor(root, device='cpu')
      assert predictor.restore()
      out = predictor.predict(mock_features(0.2, n=3))
      assert out['a_predicted'].shape == (3,)


# ------------------------------------------------------- the serving program


def _qtopt_program(kernel_policy='pool_conv', seed=1, batch_size=None):
  model, predictor = qtopt_predictor(seed=seed, kernel_policy=kernel_policy)
  return exporters.export_serving_program(
      model, predictor.network.state_dict(), batch_size), predictor


@pytest.mark.parametrize('policy, pools, convs', [
    ('pool_conv', 3, 1), ('pool', 3, 0), ('none', 0, 0)])
def test_qtopt_program_holds_the_kernels_as_custom_ops(policy, pools, convs):
  program, _ = _qtopt_program(policy)
  counts = exporters.program_op_counts(program)
  assert counts.get(POOL, 0) == pools and counts.get(CONV, 0) == convs
  if policy == 'pool_conv':
    assert not [op for op in PLAIN_OPS if op in counts], counts
  # The weights are inputs of the program, not constants.
  assert not program.state_dict and not program.constants
  specs = program.graph_signature.input_specs
  assert all(spec.kind.name == 'USER_INPUT' for spec in specs)


def test_fingerprint_equal_across_weights_and_differs_across_programs():
  first, _ = _qtopt_program(seed=1)
  second, _ = _qtopt_program(seed=2)
  other, _ = _qtopt_program('none', seed=1)
  fingerprint = exporters.serving_program_fingerprint
  assert fingerprint(first) == fingerprint(second)
  assert fingerprint(first) != fingerprint(other)
  # Node metadata (stack traces) does not enter it.
  for node in second.graph.nodes:
    node.meta['stack_trace'] = 'File "elsewhere.py", line 1'
  assert fingerprint(first) == fingerprint(second)


def test_batch_one_and_five_run_from_one_artifact(tmp_path):
  model, predictor = qtopt_predictor()
  path = export_predictor(model, predictor, tmp_path / 'export')
  fn = exporters.load_serving_fn_from_export_dir(path, device='cpu')
  params = exporters.load_state_from_export_dir(path)
  for batch in (1, 5):
    features = {k: torch.from_numpy(v)
                for k, v in qtopt_features(batch, batch).items()}
    with torch.inference_mode():
      got = fn(params, features)['q_predicted']
    want = predictor.predict({k: v.numpy() for k, v in features.items()})
    assert got.shape == (batch,)
    np.testing.assert_array_equal(got.numpy(), want['q_predicted'])


def test_pinned_batch_program_runs_only_at_its_batch():
  program, _ = _qtopt_program(batch_size=4)
  assert not program.range_constraints
  placeholder = [n for n in program.graph.nodes if n.op == 'placeholder'][-1]
  assert placeholder.meta['val'].shape[0] == 4


class _AttentionNet(nn.Module):

  def __init__(self):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(8))

  def forward(self, x):
    q = (x * self.scale).reshape(x.shape[0], 16, 1, 8)
    return flash_attention.flash_attention(q, q, q, causal=True).sum((1, 2, 3))


class _PhotometricNet(nn.Module):

  def __init__(self):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(8))

  def forward(self, x):
    images = (x * self.scale).reshape(x.shape[0], 4, 4, 8)
    ones = torch.ones((x.shape[0], 1, 1, 1))
    return photometric.fused_brightness_contrast(images, 0.1 * ones,
                                                 1.5 * ones).sum((1, 2, 3))


class _KernelModel(AbstractT2RModel):
  """A one-parameter model whose forward reaches the flash forward or the
  photometric pass."""

  def __init__(self, net_cls):
    super().__init__(device_type='cpu')
    self._net_cls = net_cls

  def create_module(self):
    return self._net_cls()

  def get_feature_specification(self, mode):
    spec = SpecStruct()
    spec['x'] = TensorSpec(shape=(16, 8), dtype=np.float32, name='x')
    return spec

  def get_label_specification(self, mode):
    return None

  def inference_network_fn(self, network, features, labels, mode):
    out = SpecStruct()
    out['y'] = network(features['x'])
    return out

  def model_train_fn(self, features, labels, inference_outputs, mode):
    raise NotImplementedError


@pytest.mark.parametrize('net_cls, op', [
    (_AttentionNet, 't2r.flash_fwd.default'),
    (_PhotometricNet, 't2r.photometric.default')],
                         ids=['attention', 'photometric'])
def test_kernels_export_as_custom_ops(net_cls, op, tmp_path):
  """The flash forward and the photometric pass are custom ops: the
  program holds one node of each, runs at a batch other than the trace's
  and gives the eager function's outputs bit for bit."""
  model = _KernelModel(net_cls)
  generator = torch.Generator().manual_seed(3)
  params = {k: torch.rand(v.shape, generator=generator) + 0.5
            for k, v in model.create_module().state_dict().items()}
  program = exporters.export_serving_program(model, params)
  assert exporters.kernel_op_counts(program) == {op: 1}
  features = {'x': torch.rand((3, 16, 8), generator=generator)}
  want = exporters.build_serving_fn(model)(params, features)['y']
  got = program.module()(params, features)['y']
  assert got.shape == (3,)
  assert torch.equal(got, want)
  state = exporters.ServingState(1, params)
  path = export_lib.ModelExporter().export(model, state, str(tmp_path))
  meta = exporters.read_export_meta(path)
  assert meta['self_contained_serving_fn'] is True
  assert meta['kernel_ops'] == {op: 1}


class _GatedNet(nn.Module):
  """Holds the first forward (the exporter's trace) open: sets
  ``entered`` and waits for ``release``."""

  def __init__(self, entered, release):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(8))
    self._entered, self._release = entered, release

  def forward(self, x):
    self._entered.set()
    assert self._release.wait(timeout=60.0)
    return (x * self.scale).sum((1, 2))


@pytest.mark.parametrize('net_cls', [_AttentionNet, _PhotometricNet])
def test_kernels_run_while_another_thread_exports(net_cls, tmp_path):
  """``torch.compiler.is_exporting()`` is process-wide; an export on a
  worker thread (``AsyncExportCallback``) must not make a kernel raise on
  the thread that trains."""
  entered, release = threading.Event(), threading.Event()
  model = _KernelModel(functools.partial(_GatedNet, entered, release))
  state = exporters.ServingState(
      1, dict(model.create_module().state_dict()))
  paths = []
  exporter = threading.Thread(target=lambda: paths.append(
      export_lib.ModelExporter().export(model, state, str(tmp_path))))
  exporter.start()
  try:
    assert entered.wait(timeout=60.0)
    net = net_cls()
    x = torch.ones((2, 16, 8), requires_grad=True)
    net(x).sum().backward()  # a train step's forward and backward
    assert x.grad.shape == (2, 16, 8)
  finally:
    release.set()
    exporter.join(timeout=120.0)
  assert not exporter.is_alive() and paths
  assert exporters.read_export_meta(paths[0])[
      'self_contained_serving_fn'] is True


_LOADER = '''
import importlib.abc, sys
class _Blocked(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if name.startswith(('tensor2robot_tpu_torch.research',
                        'tensor2robot_tpu_torch.models')):
      raise ImportError('blocked: ' + name)
    return None
sys.meta_path.insert(0, _Blocked())
import numpy as np
from tensor2robot_tpu_torch.predictors import ExportedModelPredictor
root, features, out = sys.argv[1:4]
predictor = ExportedModelPredictor(root, device='cpu')
assert predictor.restore()
np.save(out, predictor.predict(dict(np.load(features)))['q_predicted'])
leaked = sorted(m for m in sys.modules if m.startswith((
    'tensor2robot_tpu_torch.research', 'tensor2robot_tpu_torch.models')))
assert not leaked, leaked
print('loaded without the model')
'''


def test_program_loads_in_a_process_without_the_model(tmp_path):
  model, predictor = qtopt_predictor()
  root = tmp_path / 'export'
  export_predictor(model, predictor, root)
  features = qtopt_features(3, 4)
  np.savez(tmp_path / 'features.npz', **features)
  out = tmp_path / 'q.npy'
  env = dict(os.environ, PYTHONPATH=REPO)
  result = subprocess.run(
      [sys.executable, '-c', _LOADER, str(root),
       str(tmp_path / 'features.npz'), str(out)],
      cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
  assert result.returncode == 0, result.stderr[-3000:]
  assert 'loaded without the model' in result.stdout
  np.testing.assert_array_equal(np.load(out),
                                predictor.predict(features)['q_predicted'])


# ------------------------------------------------------------------ assets


def _port_specs():
  features = SpecStruct()
  features['state/image'] = TensorSpec((512, 640, 3), np.uint8,
                                       name='state/image', data_format='JPEG')
  features['action/world_vector'] = TensorSpec((3,), np.float32,
                                               name='world_vector')
  features['aux/ragged'] = TensorSpec((None, 2), np.float32, name='ragged',
                                      is_optional=True,
                                      varlen_default_value=0.25)
  features['aux/seq'] = TensorSpec((4,), 'bfloat16', name='seq "q"',
                                   is_sequence=True, dataset_key='d1')
  labels = SpecStruct()
  labels['reward'] = TensorSpec((1,), np.int64, name='reward')
  return features, labels


def _jax_specs():
  features = JaxSpecStruct()
  features['state/image'] = JaxTensorSpec((512, 640, 3), np.uint8,
                                          name='state/image',
                                          data_format='JPEG')
  features['action/world_vector'] = JaxTensorSpec((3,), np.float32,
                                                  name='world_vector')
  features['aux/ragged'] = JaxTensorSpec((None, 2), np.float32,
                                         name='ragged', is_optional=True,
                                         varlen_default_value=0.25)
  features['aux/seq'] = JaxTensorSpec((4,), 'bfloat16', name='seq "q"',
                                      is_sequence=True, dataset_key='d1')
  labels = JaxSpecStruct()
  labels['reward'] = JaxTensorSpec((1,), np.int64, name='reward')
  return features, labels


def _as_json(struct):
  return json.dumps(struct.to_json_dict(), sort_keys=True)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_assets_read_across_packages(writer, tmp_path):
  port_features, port_labels = _port_specs()
  jax_features, jax_labels = _jax_specs()
  if writer == 'port':
    port_assets.write_assets_to_export_dir(str(tmp_path), port_features,
                                           port_labels, global_step=12)
    features, labels, step = jax_assets.load_specs_from_export_dir(
        str(tmp_path))
  else:
    jax_assets.write_assets_to_export_dir(str(tmp_path), jax_features,
                                          jax_labels, global_step=12)
    features, labels, step = port_assets.load_specs_from_export_dir(
        str(tmp_path))
  assert step == 12
  assert _as_json(features) == _as_json(port_features)
  assert _as_json(labels) == _as_json(port_labels)
  # Byte for byte what protobuf's text format writes, JSON twin included.
  text = port_assets.t2r_assets_text(port_features, port_labels, 12)
  pbtxt = tmp_path / 'assets.extra' / 't2r_assets.pbtxt'
  assert pbtxt.read_text() == text
  twin = json.loads((tmp_path / 'assets.extra' / 't2r_assets.json')
                    .read_text())
  assert twin['feature_spec'] == port_features.to_json_dict()
  assert twin['global_step'] == 12


def test_exported_qtopt_assets_load_in_the_jax_package(tmp_path):
  model, predictor = qtopt_predictor()
  path = export_predictor(model, predictor, tmp_path / 'export')
  features, labels, step = jax_assets.load_specs_from_export_dir(path)
  assert step == predictor.global_step
  port = model.get_feature_specification_for_packing('predict')
  assert _as_json(features) == _as_json(port)
  assert labels.to_json_dict() == model.get_label_specification_for_packing(
      'predict').to_json_dict()


def test_unset_specs_and_step_round_trip(tmp_path):
  spec = qtopt_model().get_feature_specification_for_packing('predict')
  assert port_assets.t2r_assets_text(None, None, 0) == ''
  port_assets.write_assets_to_export_dir(str(tmp_path), spec, None, 0)
  features, labels, step = port_assets.load_specs_from_export_dir(
      str(tmp_path))
  assert (_as_json(features), len(labels), step) == (_as_json(spec), 0, 0)
