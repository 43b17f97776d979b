"""The PyTorch port imports without jax.

``tests/conftest.py`` imports jax into every test process, so the check runs
in a fresh interpreter.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "elektronn2_tpu_torch",
    "elektronn2_tpu_torch.log",
    "elektronn2_tpu_torch.config",
    "elektronn2_tpu_torch.utils",
    "elektronn2_tpu_torch.utils.cnncalculator",
    "elektronn2_tpu_torch.utils.cuda_build",
    "elektronn2_tpu_torch.utils.device_timing",
    "elektronn2_tpu_torch.utils.convert",
    "elektronn2_tpu_torch.utils.basic",
    "elektronn2_tpu_torch.utils.native_build",
    "elektronn2_tpu_torch.utils.plotting",
    "elektronn2_tpu_torch.utils.profiling",
    "elektronn2_tpu_torch.utils.gpu",
    "elektronn2_tpu_torch.utils.legacy",
    "elektronn2_tpu_torch.utils.locking",
    "elektronn2_tpu_torch.utils.d3viz",
    "elektronn2_tpu_torch.utils.ptk_completions",
    "elektronn2_tpu_torch.utils.utils_basic",
    "elektronn2_tpu_torch.ops",
    "elektronn2_tpu_torch.ops.activations",
    "elektronn2_tpu_torch.ops.conv",
    "elektronn2_tpu_torch.ops.mfp",
    "elektronn2_tpu_torch.ops.tailconv",
    "elektronn2_tpu_torch.ops.extract",
    "elektronn2_tpu_torch.ops.extract_rot",
    "elektronn2_tpu_torch.ops.warp",
    "elektronn2_tpu_torch.ops.experimental",
    "elektronn2_tpu_torch.ops.experimental.dilated_conv",
    "elektronn2_tpu_torch.neuromancer",
    "elektronn2_tpu_torch.neuromancer.graphutils",
    "elektronn2_tpu_torch.neuromancer.graphmanager",
    "elektronn2_tpu_torch.neuromancer.variables",
    "elektronn2_tpu_torch.neuromancer.optimiser",
    "elektronn2_tpu_torch.neuromancer.node_basic",
    "elektronn2_tpu_torch.neuromancer.neural",
    "elektronn2_tpu_torch.neuromancer.loss",
    "elektronn2_tpu_torch.neuromancer.model",
    "elektronn2_tpu_torch.neuromancer.inference",
    "elektronn2_tpu_torch.neuromancer.computations",
    "elektronn2_tpu_torch.neuromancer.various",
    "elektronn2_tpu_torch.training",
    "elektronn2_tpu_torch.training.fused_loop",
    "elektronn2_tpu_torch.training.parallelisation",
    "elektronn2_tpu_torch.training.trainutils",
    "elektronn2_tpu_torch.training.trainer",
    "elektronn2_tpu_torch.data",
    "elektronn2_tpu_torch.data.skeleton",
    "elektronn2_tpu_torch.data._knossos_native",
    "elektronn2_tpu_torch.data.knossos_array",
    "elektronn2_tpu_torch.data.tracing_utils",
    "elektronn2_tpu_torch.data.transformations",
    "elektronn2_tpu_torch.data._warp_native",
    "elektronn2_tpu_torch.data.image",
    "elektronn2_tpu_torch.data.cnndata",
    "elektronn2_tpu_torch.data.traindata",
    "elektronn2_tpu_torch.malis",
    "elektronn2_tpu_torch.malis.native",
    "elektronn2_tpu_torch.malis.malis_utils",
    "elektronn2_tpu_torch.malis.malisop",
    "elektronn2_tpu_torch.scripts",
    "elektronn2_tpu_torch.scripts.exp_convdense_headk",
    "elektronn2_tpu_torch.scripts.exp_headconv_tc",
    "elektronn2_tpu_torch.scripts.exp_ptail_dot",
    "elektronn2_tpu_torch.scripts.exp_ptail_ablate",
    "elektronn2_tpu_torch.scripts.exp_wrapper_host",
    "elektronn2_tpu_torch.scripts.exp_profiler_window",
    "elektronn2_tpu_torch.scripts.predict",
    "elektronn2_tpu_torch.scripts.profile",
    "elektronn2_tpu_torch.scripts.train",
    "elektronn2_tpu_torch.parallel",
    "elektronn2_tpu_torch.parallel.mesh",
    "elektronn2_tpu_torch.parallel.multihost",
    "elektronn2_tpu_torch.parallel.data_parallel",
    "elektronn2_tpu_torch.parallel.halo",
    "elektronn2_tpu_torch.parallel.spatial_train",
    "elektronn2_tpu_torch.parallel.tensor_parallel",
    "elektronn2_tpu_torch.parallel.pipeline",
]

#: a meta-path finder that refuses jax, the JAX package and the reference
#: shim: what a machine without them does (the card's has no jax)
BLOCK = ("import sys\n"
         "class _Block:\n"
         "    def find_spec(self, name, path=None, target=None):\n"
         "        top = name.split('.')[0]\n"
         "        if top in ('jax', 'jaxlib', 'elektronn2_tpu', "
         "'elektronn2'):\n"
         "            raise ImportError('blocked: ' + name)\n"
         "sys.meta_path.insert(0, _Block())\n")


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'elektronn2_tpu'\n"
            "             or k.startswith('elektronn2_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_flagship_builds_and_runs_without_jax():
    # the whole slice (graph, dense path, kernel wrapper on CPU) stays
    # jax-free when it runs, not only when it is imported
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.utils.convert import flagship_model\n"
            "m = flagship_model(mfp=True, patch=[9, 41, 41], device='cpu')\n"
            "m.set_dilated_impl('direct', zfold=True, pallas_tail=True)\n"
            "y = m.predict_dense_device(torch.rand(1, 7, 30, 30), pad_raw=True)\n"
            "assert tuple(y.shape) == (2, 7, 30, 30), y.shape\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_unet_conv_dense_runs_without_jax():
    # the conv-dense slice (decoder graph, every lowering knob, K1's and
    # K4's wrappers on the CPU, the probe's shapes) stays jax-free when it
    # runs
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.utils.convert import wide_unet_model\n"
            "from elektronn2_tpu_torch.ops.tailconv import "
            "conv1x3x3_pool_dilated\n"
            "from elektronn2_tpu_torch.scripts import exp_convdense_headk\n"
            "m = wide_unet_model(widths=(4, 8, 16), device='cpu')\n"
            "m.set_convdense_impl(zfold=True, skipsum=True, ptail=True)\n"
            "y = m.predict_dense_device(torch.rand(1, 10, 40, 44), "
            "pad_raw=True)\n"
            "assert tuple(y.shape) == (2, 10, 40, 44), y.shape\n"
            "h = conv1x3x3_pool_dilated(torch.rand(1, 2, 3, 9, 9), "
            "torch.rand(4, 2, 1, 3, 3), torch.rand(4))\n"
            "assert tuple(h.shape) == (1, 4, 3, 6, 6), h.shape\n"
            "assert len(exp_convdense_headk.cases()) == 5\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_serving_tune_runs_without_jax():
    # reduced-precision serving, the serving autotune through the predict
    # CLI (--tune --int8, no HDF5 output), calibrate_int8 and the profile
    # CLI stay jax-free when they run
    code = ("import os, sys, tempfile, numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.utils.convert import flagship_model\n"
            "from elektronn2_tpu_torch.data.knossos_array import (\n"
            "    KnossosArray, save_knossos)\n"
            "from elektronn2_tpu_torch.scripts import predict, profile\n"
            "d = tempfile.mkdtemp()\n"
            "m = flagship_model(mfp=True, patch=[9, 41, 41], device='cpu')\n"
            "mdl = os.path.join(d, 'f.mdl')\n"
            "m.save(mdl)\n"
            "raw = (np.random.RandomState(0).rand(10, 40, 40) * 255"
            ").astype(np.uint8)\n"
            "save_knossos(raw, os.path.join(d, 'raw'), exp_name='raw',\n"
            "             cube_edge=16)\n"
            "assert predict.main([mdl, os.path.join(d, 'raw'), '--cpu',\n"
            "    '--tune', '--int8', '--step', '6,20,20', '-o', '',\n"
            "    '--knossos-out', os.path.join(d, 'out')]) == 0\n"
            "assert KnossosArray(os.path.join(d, 'out', 'c0')).shape[-3:]"
            " == (10, 40, 40)\n"
            "m.set_compute_dtype('int8', activations=True)\n"
            "m.calibrate_int8(torch.rand(1, 10, 40, 40))\n"
            "m.set_compute_dtype('bfloat16')\n"
            "assert torch.isfinite(m.predict_dense_device(\n"
            "    torch.rand(1, 7, 30, 30), pad_raw=True)).all()\n"
            "assert profile.main([mdl, '--sizes', '41', '--out',\n"
            "    os.path.join(d, 'p.csv'), '--cpu']) == 0\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'elektronn2_tpu'\n"
            "             or k.startswith('elektronn2_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_tracing_rollout_runs_without_jax():
    # the tracing slice (graph, rollout, both patch cuts, KNOSSOS export)
    # stays jax-free when it runs
    code = ("import os, sys, tempfile, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.utils.convert import tracer_model\n"
            "from elektronn2_tpu_torch.data.tracing_utils import DeviceTracer\n"
            "m = tracer_model((4, 4, 4), enc_w=8, gru_w=8, device='cpu')\n"
            "vol = torch.rand(1, 16, 16, 16)\n"
            "d = tempfile.mkdtemp()\n"
            "for rot in (False, True):\n"
            "    t = DeviceTracer(m, vol, max_steps=3, rotate_to_heading=rot)\n"
            "    tr = t.trace_batch([[8.0, 8.0, 8.0]],\n"
            "                       save_kzip=os.path.join(d, 'a.k.zip'))\n"
            "    assert len(tr) == 1 and len(tr[0].coords) >= 1\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_tracing_campaign_runs_without_jax():
    # the tracing campaign (the respawning and chained pools, the pooled
    # registry drain, tune_batch, the host Tracer, the bf16 rotated mode)
    # and tracing training (examples/tracing3d.py through the train CLI,
    # AgentData, TracingTrainer) stay jax-free when they run
    code = ("import os, sys, tempfile, numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.utils.convert import tracer_model\n"
            "from elektronn2_tpu_torch.data.tracing_utils import (\n"
            "    DeviceTracer, ShotgunRegistry, Tracer)\n"
            "from elektronn2_tpu_torch.scripts.train import main\n"
            "m = tracer_model((4, 4, 4), enc_w=8, gru_w=8, device='cpu')\n"
            "vol = torch.rand(1, 16, 16, 16)\n"
            "seeds = np.random.RandomState(0).uniform(6, 10, (5, 3))\n"
            "for rot in (False, True):\n"
            "    t = DeviceTracer(m, vol, max_steps=3, rotate_to_heading=rot,\n"
            "                     rot_compute_dtype='bfloat16')\n"
            "    tr, st = t.trace_pool(seeds, batch_size=2)\n"
            "    assert st['consumed'] == 5 and len(tr) == 5\n"
            "    tr, st = t.trace_pool_chain(seeds, batch_size=2,\n"
            "                                wave_seeds=2, wave_steps=2)\n"
            "    assert st['consumed'] == 5 and st['waves'] >= 3\n"
            "    assert len(ShotgunRegistry(seeds, radius=0.01).run(\n"
            "        t, batch_size=2, pool=True)) == 5\n"
            "    assert Tracer(m, vol.numpy(), max_steps=2,\n"
            "                  rotate_to_heading=rot).trace(seeds[0])\n"
            "assert set(t.tune_batch((2,), steps=2)['table']) == {2}\n"
            "d = tempfile.mkdtemp()\n"
            "assert main(['--cpu', 'examples/tracing3d.py', '--n-steps', "
            "'3', '--save-path', d]) == 0\n"
            "assert os.path.exists(os.path.join(d, 'tracing3d-LAST.mdl'))\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'elektronn2_tpu'\n"
            "             or k.startswith('elektronn2_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_k5_and_probes_run_without_jax():
    # K5 and the two probes of K1 (their wrappers' plain versions on the
    # CPU) stay jax-free when they run
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.ops.experimental.dilated_conv import "
            "dilated_conv\n"
            "from elektronn2_tpu_torch.scripts import exp_ptail_ablate, "
            "exp_ptail_dot\n"
            "y = dilated_conv(torch.rand(6, 7, 3, 20), torch.rand(5, 3, 3, 3, "
            "3), 2, Yo=12)\n"
            "assert tuple(y.shape) == (2, 3, 8, 12), y.shape\n"
            "o = exp_ptail_dot.dot_rows(torch.rand(4, 16).bfloat16(), "
            "torch.rand(32, 128).bfloat16(), 2)\n"
            "assert tuple(o.shape) == (2, 128), o.shape\n"
            "a = exp_ptail_ablate.ablate('full', torch.rand(1, 2, 5, 9, 9), "
            "torch.rand(40, 2, 3, 3, 3), torch.rand(40), (1, 2, 2))\n"
            "assert tuple(a.shape) == (1, 40, 3, 5, 5), a.shape\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_training_runs_without_jax():
    # the training slice (optimiser, trainingstep, augmenter, fused loop,
    # save with the optimiser state and load) stays jax-free when it runs
    code = ("import os, sys, tempfile, numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.utils.convert import "
            "neuro3d_train_model\n"
            "from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter\n"
            "from elektronn2_tpu_torch.training.fused_loop import "
            "FusedTrainLoop\n"
            "from elektronn2_tpu_torch.neuromancer.model import modelload\n"
            "m = neuro3d_train_model(2, (7, 30, 30), widths=(3, 3, 4, 4), "
            "device='cpu')\n"
            "ps = m.prediction_node.shape\n"
            "r = [np.random.RandomState(0).rand(1, 12, 50, 50)"
            ".astype(np.float32)]\n"
            "a = DeviceBatchAugmenter(r, [(r[0][0] > 0.5).astype(np.int16)], "
            "m.input_node.shape.spatial_shape, ps.spatial_shape, ps.strides, "
            "grey_channels=[0], device='cpu')\n"
            "losses, _ = FusedTrainLoop(m, a, 2, 2).run_chunk()\n"
            "assert np.isfinite(losses).all() and losses.shape == (2,)\n"
            "f = os.path.join(tempfile.mkdtemp(), 'm.mdl')\n"
            "m.save(f)\n"
            "assert int(modelload(f, device='cpu').opt_state['step']) == 2\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_sweep_and_cli_run_without_jax():
    # the dense-serving deployment (KNOSSOS dataset, sweep with slab
    # batches, the predict CLI with rebuild and KNOSSOS output) stays
    # jax-free when it runs
    code = ("import os, sys, tempfile, numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.utils.convert import flagship_model\n"
            "from elektronn2_tpu_torch.data.knossos_array import "
            "KnossosArray, save_knossos\n"
            "from elektronn2_tpu_torch.scripts.predict import main\n"
            "d = tempfile.mkdtemp()\n"
            "raw = (np.random.RandomState(0).rand(8, 30, 30) * 255)"
            ".astype(np.uint8)\n"
            "save_knossos(raw, os.path.join(d, 'raw'), cube_edge=16)\n"
            "m = flagship_model(mfp=False, patch=[9, 44, 44], device='cpu')\n"
            "m.set_dilated_impl('direct', zfold=True, pallas_tail=True)\n"
            "ka = KnossosArray(os.path.join(d, 'raw'))\n"
            "y = m.sweep_knossos(ka, step=[4, 16, 16], slab_batch=2)\n"
            "assert y.shape == (2, 8, 30, 30), y.shape\n"
            "m.save(os.path.join(d, 'm.mdl'))\n"
            "assert main([os.path.join(d, 'm.mdl'), os.path.join(d, 'raw'), "
            "'--cpu', '--mfp', '--patch', '9,41,41', '--ptail', '--step', "
            "'4,16,16', '-o', os.path.join(d, 'p.h5'), '--knossos-out', "
            "os.path.join(d, 'out')]) == 0\n"
            "assert KnossosArray(os.path.join(d, 'out', 'c1')).shape == "
            "(8, 30, 30)\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_example_configs_load_without_jax():
    # the config loader execs the unchanged example files, whose
    # create_model imports the JAX package by name; the port builds their
    # models (at full width, on the CPU) and one batch each without loading
    # jax or the JAX package (TensorBoard is off: its writer may pull in
    # other frameworks)
    code = ("import sys, tempfile, numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.config import ExperimentConfig\n"
            "from elektronn2_tpu_torch.training import Trainer\n"
            "for name in ('neuro2d', 'neuro3d', 'neuro3d_fast', 'unet3d',\n"
            "             'unet3d_wide'):\n"
            "    exp = ExperimentConfig.from_file(\n"
            "        f'examples/{name}.py', override={\n"
            "            'save_path': tempfile.mkdtemp(),\n"
            "            'tensorboard': False})\n"
            "    tr = Trainer(exp, device='cpu')\n"
            "    d, t = tr.debug_getbatch()\n"
            "    d, t = np.asarray(d), np.asarray(t)\n"
            "    assert d.shape[0] == exp.batch_size and np.isfinite(d).all()\n"
            "    assert tuple(d.shape[2:]) == tuple(\n"
            "        tr.model.input_node.shape.spatial_shape), (name, d.shape)\n"
            "    assert tuple(t.shape[1:]) == tuple(\n"
            "        tr.model.target_node.shape.spatial_shape), (name, t.shape)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'elektronn2_tpu'\n"
            "             or k.startswith('elektronn2_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_package_data_ships_every_source():
    # an installed port (not a checkout) builds its kernels and cores from
    # the files pyproject.toml's package-data lists: every source under
    # csrc/ and every .cpp must match one of its patterns
    import glob
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        cfg = tomllib.load(f)
    pats = cfg["tool"]["setuptools"]["package-data"]["elektronn2_tpu_torch"]
    pkg = os.path.join(REPO, "elektronn2_tpu_torch")
    shipped = set()
    for p in pats:
        shipped |= set(glob.glob(p, root_dir=pkg, recursive=True))
    need = {os.path.join("csrc", f)
            for f in os.listdir(os.path.join(pkg, "csrc"))}
    need |= {os.path.relpath(p, pkg) for p in glob.glob(
        os.path.join(pkg, "**", "*.cpp"), recursive=True)}
    assert any(n.endswith(".cuh") for n in need)
    assert any(n.endswith(".cpp") for n in need)
    assert not need - shipped, sorted(need - shipped)


def test_package_source_names_no_jax():
    # no module of the port imports jax or the JAX package
    root = os.path.join(REPO, "elektronn2_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            p = os.path.join(dirpath, f)
            with open(p) as fh:
                for i, line in enumerate(fh, 1):
                    s = line.strip()
                    if (s.startswith(("import jax", "from jax"))
                            or s.startswith("import elektronn2_tpu ")
                            or s.startswith("import elektronn2_tpu.")
                            or s.startswith("from elektronn2_tpu ")
                            or s.startswith("from elektronn2_tpu.")):
                        offenders.append(f"{p}:{i}: {s}")
    assert not offenders, offenders


def test_train_nodes_run_without_jax():
    # the training nodes (batch norm, dropout, prelu, the skeleton losses),
    # the lowerings and remat, the BN net's save/load and dense serving,
    # and mlp_mnist through the train CLI stay jax-free when they run
    code = ("import os, sys, tempfile, numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.utils.convert import (\n"
            "    NEURO3D_FILTERS, NEURO3D_POOLS, neuro3d_bn_train_model,\n"
            "    tracer_model)\n"
            "from elektronn2_tpu_torch.utils.cnncalculator import "
            "cnncalculator\n"
            "from elektronn2_tpu_torch.neuromancer.model import modelload\n"
            "from elektronn2_tpu_torch.data import skeleton as sk\n"
            "import elektronn2_tpu_torch.neuromancer as nm\n"
            "from elektronn2_tpu_torch.scripts.train import main\n"
            "m = neuro3d_bn_train_model(2, (7, 25, 25), widths=(3, 3, 4, 4),"
            " device='cpu')\n"
            "x = torch.rand(*m.input_node.shape)\n"
            "t = (torch.rand(*m.target_node.shape) > 0.5).int()\n"
            "for kw, remat in ((dict(), False), (dict(zfold=True), True)):\n"
            "    m.set_train_lowering(**kw)\n"
            "    m.set_remat(remat)\n"
            "    assert np.isfinite(float(m.trainingstep(x, t)[0]))\n"
            "d = tempfile.mkdtemp()\n"
            "m.save(os.path.join(d, 'bn.mdl'))\n"
            "p = cnncalculator(NEURO3D_FILTERS, NEURO3D_POOLS, [7, 25, 25],\n"
            "                  mfp=True, ndim=3).input\n"
            "s = modelload(os.path.join(d, 'bn.mdl'), device='cpu',\n"
            "              override_mfp_to_active=True, imposed_patch_size=p)\n"
            "assert sorted(s.state) == ['conv0', 'conv1', 'conv2', 'conv3']\n"
            "s.set_dilated_impl('direct', pallas_tail=True)\n"
            "y = s.predict_dense_device(torch.rand(1, 9, 30, 30), "
            "pad_raw=True)\n"
            "assert tuple(y.shape) == (2, 9, 30, 30), y.shape\n"
            "tm = tracer_model((4, 4, 4), enc_w=8, gru_w=8, prelu_w=6,\n"
            "                  device='cpu')\n"
            "sk.clear_skeleton_registry()\n"
            "line = sk.SkeletonMFK(np.stack([np.full(9, 5.), np.full(9, 5.),\n"
            "                      np.arange(9.) + 2], 1),\n"
            "                      [(i, i + 1) for i in range(8)])\n"
            "sid = sk.register_skeleton(line)\n"
            "f = sk.skeleton_distance_field([line], (12, 12, 12))\n"
            "nm.model_manager.reset()\n"
            "a = nm.Input([2, 3], 'b,f', name='pred')\n"
            "g = nm.GenericInput(name='skel')\n"
            "o = nm.AggregateLoss([nm.SkelLoss(a, g),\n"
            "                      nm.SkelLossField(a, g, f)])\n"
            "h = nm.model_manager.getmodel()\n"
            "h.designate_nodes(input_node=a, prediction_node=o,\n"
            "                  extra_inputs=[g])\n"
            "feed = torch.tensor([[sid, 5., 5., 4.], [sid, 5., 6., 6.]])\n"
            "assert np.isfinite(float(h.predict(torch.rand(2, 3), "
            "extra=[feed])[0]))\n"
            "assert main(['--cpu', 'examples/mlp_mnist.py', '--n-steps', "
            "'3', '--save-path', d]) == 0\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'elektronn2_tpu'\n"
            "             or k.startswith('elektronn2_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_malis_and_reduced_matmuls_run_without_jax():
    # MALIS (the native core, make_affinities, malis3d through the train
    # CLI) and a bf16 step of the GRU tracer model stay jax-free when they
    # run
    code = ("import os, sys, tempfile, numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch import malis\n"
            "from elektronn2_tpu_torch.data.image import make_affinities\n"
            "from elektronn2_tpu_torch.scripts.train import main\n"
            "from elektronn2_tpu_torch.utils.convert import tracer_model\n"
            "assert malis.HAVE_NATIVE\n"
            "seg = np.zeros((3, 6, 6), np.int32)\n"
            "seg[:, :3] = 1\n"
            "seg[:, 3:] = 2\n"
            "aff, cc = make_affinities(seg)\n"
            "pos, neg = malis.malis_weights(np.random.rand(*aff.shape), cc)\n"
            "assert pos.sum() > 0 and neg.sum() > 0\n"
            "d = tempfile.mkdtemp()\n"
            "assert main(['--cpu', 'examples/malis3d.py', '--n-steps', "
            "'3', '--save-path', d]) == 0\n"
            "assert os.path.exists(os.path.join(d, 'malis3d-LAST.mdl'))\n"
            "m = tracer_model((4, 4, 4), enc_w=8, gru_w=8, device='cpu')\n"
            "m.set_compute_dtype('bfloat16')\n"
            "m.set_opt('SGD', lr=0.01)\n"
            "x = torch.rand(*m.input_node.shape)\n"
            "t = torch.rand(*m.target_node.shape)\n"
            "assert np.isfinite(float(m.trainingstep(x, t)[0]))\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'elektronn2_tpu'\n"
            "             or k.startswith('elektronn2_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_no_unported_error_cites_items_6_or_7_outside_the_tpu_lowerings():
    # MALIS (item 6), the reduced-precision matmuls and the dilated path's
    # TPU lowerings (item 7) are ported: no line of the package cites item
    # 6 or item 7, and no lowering setter raises NotImplementedError
    import inspect
    from elektronn2_tpu_torch.neuromancer.model import Model
    root = os.path.join(REPO, "elektronn2_tpu_torch")
    cites = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            with open(p) as fh:
                for i, line in enumerate(fh, 1):
                    if "item 6" in line or "item 7" in line:
                        cites.append(f"{rel}:{i}")
    assert not cites, cites
    for name in ("set_compute_dtype", "set_dilated_impl",
                 "set_convdense_impl"):
        src = inspect.getsource(getattr(Model, name))
        assert "NotImplementedError" not in src and "item 7" not in src


def test_lowerings_run_without_jax():
    # the lowering ops, K1's bf16 mode and an s2bg / zmajor / ztap request
    # import and run with jax and the JAX package blocked, equal to direct
    code = (BLOCK + "import torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.neuromancer.computations import "
            "conv_s2b\n"
            "from elektronn2_tpu_torch.ops.conv import (conv_ztap, pool_s2b,\n"
            "    _s2b_split, _s2b_split_zmajor, _s2b_merge)\n"
            "from elektronn2_tpu_torch.ops.tailconv import "
            "conv3x3_dilated\n"
            "from elektronn2_tpu_torch.utils.convert import flagship_model\n"
            "m = flagship_model(mfp=True, patch=[9, 41, 41], device='cpu')\n"
            "v = torch.rand(1, 7, 30, 30)\n"
            "ref = m.predict_dense_device(v, pad_raw=True)\n"
            "for impl, kw in (('s2bg', dict(zfold=True)), ('s2b', {}),\n"
            "                 ('s2bg', dict(zmajor=True, ztap='fatn')),\n"
            "                 ('direct', dict(ztap='concat', "
            "poolslice=True))):\n"
            "    m.set_dilated_impl(impl, **kw)\n"
            "    got = m.predict_dense_device(v, pad_raw=True)\n"
            "    assert (got - ref).abs().max() < 1e-5, (impl, kw)\n"
            "x = torch.rand(1, 3, 5, 12, 12)\n"
            "w = torch.rand(4, 3, 3, 3, 3)\n"
            "b = torch.rand(4)\n"
            "y = conv3x3_dilated(x, w, b, (1, 2, 2), "
            "compute_dtype='bfloat16')\n"
            "assert y.shape == (1, 4, 3, 8, 8)\n"
            "assert not [k for k in sys.modules if k.split('.')[0] in\n"
            "            ('jax', 'elektronn2_tpu', 'elektronn2')]\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_new_surface_names_import_without_jax():
    # the reference import surface the port gained (ROADMAP.md item 9) and
    # the parallel package import with jax and the JAX package blocked
    code = (BLOCK + "from elektronn2_tpu_torch.utils import (h5save, h5load,\n"
            "    picklesave, pickleload, timeit, cache, AccumulationArray,\n"
            "    DynamicKDT)\n"
            "from elektronn2_tpu_torch.utils.utils_basic import (\n"
            "    unique_rows, makeversiondir, import_variable_from_file,\n"
            "    pretty_string_ops, get_free_cpu_count, CircularBuffer)\n"
            "from elektronn2_tpu_torch.neuromancer import (Input_like,\n"
            "    rebuild_model)\n"
            "from elektronn2_tpu_torch.neuromancer.variables import (\n"
            "    VariableParam, VariableWeight, ConstantParam)\n"
            "from elektronn2_tpu_torch.neuromancer.graphutils import "
            "make_func\n"
            "from elektronn2_tpu_torch.ops import dot, upconv, unpooling, "
            "upsampling\n"
            "from elektronn2_tpu_torch.parallel import make_mesh, mesh_info\n"
            "from elektronn2_tpu_torch.parallel.multihost import (\n"
            "    initialize, global_mesh, is_main_process)\n"
            "initialize()\n"
            "m = global_mesh(device='cpu')\n"
            "assert mesh_info(m) == {'axes': {'data': 1}, 'n_devices': 1,\n"
            "                        'platform': 'cpu'}, mesh_info(m)\n"
            "assert is_main_process()\n"
            "assert not [k for k in sys.modules if k.split('.')[0] in\n"
            "            ('jax', 'elektronn2_tpu', 'elektronn2')]\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_sharded_serving_runs_without_jax():
    # the sharded-serving names import, and a mesh of one serves the
    # dilated and decoder legs and traces, with jax and the JAX package
    # blocked; each equals its unsharded call
    code = (BLOCK + "import numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.ops.conv import apply_layer\n"
            "from elektronn2_tpu_torch.neuromancer.inference import (\n"
            "    predict_dense_sharded, predict_dense_sharded_batch)\n"
            "from elektronn2_tpu_torch.parallel import (make_mesh,\n"
            "    halo_gather, cp_conv_z, spatial_cp_stack)\n"
            "from elektronn2_tpu_torch.utils.convert import (\n"
            "    flagship_model, tracer_model)\n"
            "from elektronn2_tpu_torch.data.tracing_utils import "
            "DeviceTracer\n"
            "mesh = make_mesh({'data': 1, 'space': 1}, devices='cpu')\n"
            "r = np.random.RandomState(0)\n"
            "m = flagship_model(mfp=True, patch=[9, 41, 41], device='cpu')\n"
            "v = torch.from_numpy(r.rand(1, 10, 44, 44).astype('f4'))\n"
            "a = m.predict_dense_sharded(v, mesh, pad_raw=True)\n"
            "assert (a - m.predict_dense_device(v, pad_raw=True)).abs()"
            ".max() < 1e-6\n"
            "t = tracer_model((5, 5, 5), enc_w=8, gru_w=8, batch=2, t=3,\n"
            "                 device='cpu')\n"
            "dt = DeviceTracer(t, r.rand(1, 20, 20, 20).astype('f4'),\n"
            "                  max_steps=3)\n"
            "s = r.uniform(8, 12, (3, 3)).astype('f4')\n"
            "for p, q in zip(dt.trace_batch(s, mesh=mesh),\n"
            "                dt.trace_batch(s)):\n"
            "    assert np.array_equal(p.coords, q.coords)\n"
            "assert not [k for k in sys.modules if k.split('.')[0] in\n"
            "            ('jax', 'elektronn2_tpu', 'elektronn2')]\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_no_error_cites_items_8b_or_8c():
    # sharded serving (8b) and agent-parallel tracing (8c) are ported: no
    # line of the package cites either item
    root = os.path.join(REPO, "elektronn2_tpu_torch")
    cites = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    cites += [f"{f}:{i}" for i, line in enumerate(fh, 1)
                              if "item 8b" in line or "item 8c" in line
                              or "8b)" in line or "8c)" in line]
    assert not cites, cites


def test_reference_style_config_trains_without_jax(tmp_path):
    # a config that imports only elektronn2.* builds the port's Model and
    # trains through the port's Trainer, with jax and the JAX package (and
    # the elektronn2 shim over it) blocked
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_compat_shim import REFERENCE_STYLE_CONFIG
    cfg = tmp_path / "refstyle_config.py"
    cfg.write_text(REFERENCE_STYLE_CONFIG)
    code = (BLOCK + "import numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.config import ExperimentConfig\n"
            "from elektronn2_tpu_torch.neuromancer.model import Model\n"
            "from elektronn2_tpu_torch.training.trainer import Trainer\n"
            f"exp = ExperimentConfig.from_file({str(cfg)!r}, override={{\n"
            f"    'save_path': {str(tmp_path)!r}}})\n"
            "assert type(exp.create_model()) is Model\n"
            "tr = Trainer(exp, device='cpu')\n"
            "hist = tr.run()\n"
            "assert tr.step == 4\n"
            "assert np.isfinite([r[2] for r in hist.timeline]).all()\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_neuro3d_pod_loads_and_trains_without_jax(tmp_path):
    # examples/neuro3d_pod.py counts its devices with `import jax` while it
    # is exec'd: the loader's stand-in answers (one device on the CPU), and
    # the CLI trains it under a mesh of one
    code = (BLOCK + "import os, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.config import ExperimentConfig\n"
            "from elektronn2_tpu_torch.scripts.train import main\n"
            "exp = ExperimentConfig.from_file('examples/neuro3d_pod.py')\n"
            "assert exp.mesh_axes == {'data': 1}, exp.mesh_axes\n"
            "assert exp.batch_size == 4 and exp.fused_steps == 8\n"
            f"d = {str(tmp_path)!r}\n"
            "assert main(['--cpu', 'examples/neuro3d_pod.py', '--n-steps',\n"
            "             '2', '--save-path', d]) == 0\n"
            "assert os.path.exists(os.path.join(d, 'neuro3d_pod-LAST.mdl'))\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_scaleout_training_runs_without_jax():
    # the scale-out training names import with jax and the JAX package
    # blocked, and each trains on a mesh of one: a DP x SP step, a fused
    # chunk, use_mesh(model_axis=) and a GPipe step, each equal to the
    # unsharded step
    code = (BLOCK + "import numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "import elektronn2_tpu_torch.neuromancer as nm\n"
            "from elektronn2_tpu_torch.parallel import (make_mesh,\n"
            "    make_spatial_dp_trainstep, make_fused_spatial_trainstep,\n"
            "    pad_target_for_spatial, spatial_tp_shardings, gpipe_stack,\n"
            "    microbatch, gpipe_reference_loss, make_gpipe_trainstep,\n"
            "    layers_from_model)\n"
            "from elektronn2_tpu_torch.parallel.spatial_train import "
            "conv_supports_halo\n"
            "from elektronn2_tpu_torch.parallel.halo import "
            "halo_gather_grad\n"
            "from elektronn2_tpu_torch.parallel.tensor_parallel import "
            "tp_dims\n"
            "def net():\n"
            "    nm.model_manager.reset(seed=11)\n"
            "    inp = nm.Input([2, 1, 8, 14, 14], 'b,f,z,x,y', name='raw')\n"
            "    h = nm.Conv(inp, 4, (3, 3, 3), (1, 2, 2), name='c1')\n"
            "    pr = nm.Softmax(nm.Conv(h, 2, 1, 1, activation_func='lin'))\n"
            "    t = nm.Input([2, *pr.shape.spatial_shape], 'b,z,x,y',\n"
            "                 dtype='int32', name='target')\n"
            "    m = nm.model_manager.getmodel()\n"
            "    m.designate_nodes(input_node=inp, target_node=t,\n"
            "        loss_node=nm.AggregateLoss(nm.MultinoulliNLL(pr, t,\n"
            "        target_is_sparse=True)), prediction_node=pr)\n"
            "    m.set_opt('SGD', lr=0.05, mom=0.0)\n"
            "    return m\n"
            "r = np.random.RandomState(0)\n"
            "d = torch.from_numpy(r.rand(2, 1, 8, 14, 14).astype('f4'))\n"
            "t = torch.from_numpy((r.rand(2, 6, 6, 6) > .5).astype('i4'))\n"
            "ref = net()\n"
            "want = float(ref.trainingstep(d, t)[0])\n"
            "mesh = make_mesh({'data': 1, 'space': 1, 'model': 1},\n"
            "                 devices='cpu')\n"
            "m = net()\n"
            "step = make_spatial_dp_trainstep(m, mesh)\n"
            "got = float(step(m.params, m.opt_state, m.state, d,\n"
            "    pad_target_for_spatial(t, 8),\n"
            "    m.optimiser.current_hyper('cpu'), None)[0])\n"
            "assert abs(got - want) <= 1e-6 * want, (got, want)\n"
            "m = net()\n"
            "chunk = make_fused_spatial_trainstep(m, mesh, 1)\n"
            "got = chunk(m.params, m.opt_state, m.state, d[None],\n"
            "    pad_target_for_spatial(t, 8)[None],\n"
            "    m.optimiser.current_hyper('cpu'), None)[0]\n"
            "assert abs(float(got[0]) - want) <= 1e-6 * want\n"
            "m = net().use_mesh(mesh, model_axis='model')\n"
            "assert m._tp_dims['c1'] == {'w': 0, 'b': 0}\n"
            "got = float(m.trainingstep(d, t)[0])\n"
            "assert abs(got - want) <= 1e-6 * want\n"
            "pipe = make_mesh({'pipe': 1}, devices='cpu')\n"
            "m = net()\n"
            "step = make_gpipe_trainstep(m, pipe, 2, 1)\n"
            "got = float(step(m.params, m.opt_state, microbatch(d, 2),\n"
            "    microbatch(t, 2), m.optimiser.current_hyper('cpu'))[0])\n"
            "assert abs(got - want) <= 1e-6 * want, (got, want)\n"
            "assert not [k for k in sys.modules if k.split('.')[0] in\n"
            "            ('jax', 'elektronn2_tpu', 'elektronn2')]\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_no_error_cites_items_8d_8e_or_8f():
    # spatial and tensor-parallel training (8d), GPipe (8e) and host-pass
    # losses under a mesh (8f) are ported: no line of the package cites
    # them
    root = os.path.join(REPO, "elektronn2_tpu_torch")
    cites = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    cites += [f"{f}:{i}" for i, line in enumerate(fh, 1)
                              if any(k in line for k in (
                                  "item 8d", "item 8e", "item 8f", "8d/8e",
                                  "8d)", "8e)", "8f)"))]
    assert not cites, cites
