"""chip_smoke.py: its phases at tiny size on the CPU, its refusal to run
without a GPU, and (marked ``gpu``) the same phases at served size on a
card."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

TINY = dict(features=32, out_channels=(32, 32, 64, 64))


@pytest.fixture(scope="module")
def tiny_clip_model():
    return cs.build_clip_model("vits", jnp.float32, 0, **TINY)


def test_main_refuses_without_gpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_script_alone_refuses(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=dict(os.environ, JAX_PLATFORMS="cpu",
                                   PYTHONPATH=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_main_path_imports_no_optional_package():
    code = ("import sys, importlib.abc\n"
            "class B(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path, target=None):\n"
            "        if name.split('.')[0] in %r:\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, B())\n"
            "import chip_smoke\n"
            "chip_smoke.check_imports()\n" % (cs.OPTIONAL,))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_dispatch_report_names_every_call_site():
    cases = cs.attention_cases()
    chosen = cs.report_dispatch(cases, "gpu", jnp.bfloat16)
    assert set(chosen) == {c[0] for c in cases}
    assert chosen["vit_self_518x518"] == "cudnn"
    assert cs.report_dispatch(cases, "cpu", jnp.bfloat16)[
        "vit_self_518x518"] == "xla"


def test_attention_phase_tiny():
    res = cs.phase_attention(cs.attention_cases(full=False), jnp.float32,
                             ("xla",), reps=1)
    assert set(res) == {"vit_self", "memory_bank", "temporal"}
    assert all("fwd_bwd_ms" in r["xla"] for r in res.values())


def test_checks_fail_loudly():
    with pytest.raises(AssertionError):
        cs.check("x", 1.0, 0.5)
    with pytest.raises(AssertionError):
        cs.check("x", float("nan"), 0.5)
    assert cs.aligned_rel_l1(2 * np.arange(5.0) + 1, np.arange(5.0)) < 1e-12


def test_clip_phase_tiny(tiny_clip_model):
    model, params = tiny_clip_model
    res = cs.phase_clip(model, params, cs.synthetic_clip(40, 30, 44), 28,
                        reps=1)
    # float32 compute: only the precision of the dots differs
    assert res["feature_err"] < 1e-4 and res["preact_err"] < 1e-4
    assert res["bf16_grid_share"] < cs.BF16_GRID_TOL


def test_bf16_grid_share():
    x = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    assert cs.bf16_grid_share(x) < 1e-3
    on_grid = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    assert cs.bf16_grid_share(np.concatenate([on_grid, [0.0]])) == 1.0
    with pytest.raises(AssertionError):
        cs.bf16_grid_share(np.zeros(4))


def test_stream_phase_tiny(tiny_clip_model):
    model, params = tiny_clip_model
    res = cs.phase_stream(model, params, cs.synthetic_clip(17, 30, 44), 28,
                          8)
    assert res["ms_per_frame"] > 0


def test_context_parallel_phase_on_the_cpu_mesh():
    """The --chips 4 forward comparison, over every virtual device."""
    n = jax.device_count()
    res = cs.phase_context_parallel("vits", jnp.float32, 1, n, 70, n)
    assert res["rel_err"] < 1e-4  # fp32: only the summation order differs


def test_data_parallel_phase_on_the_cpu_mesh():
    """The --chips 4 train-step comparison, over every virtual device."""
    n = jax.device_count()
    res = cs.phase_data_parallel("vits", jnp.float32, 0, n, 2, 70, n)
    assert np.isfinite(res["loss_one"])


def test_lowered_step_scan():
    assert cs.attention_impls_in("__cudnn$fmhaSoftmax __cudnn$fmhaSoftmax"
                                 "Backward") == {"cudnn_fwd": True,
                                                 "cudnn_bwd": True}
    assert cs.attention_impls_in("dot_general") == {"cudnn_fwd": False,
                                                    "cudnn_bwd": False}


@pytest.mark.gpu
def test_attention_on_gpu(gpu_device):
    res = cs.phase_attention(cs.attention_cases(), jnp.bfloat16,
                             ("cudnn", "xla"), reps=3)
    assert set(res) == {c[0] for c in cs.attention_cases()}


@pytest.mark.gpu
def test_clip_and_stream_on_gpu(gpu_device):
    model, params = cs.build_clip_model("vitl", jnp.bfloat16, 0)
    frames = cs.synthetic_clip(54, 480, 640)
    cs.phase_clip(model, params, frames, 518, reps=2)
    cs.phase_stream(model, params, frames[:25], 518, 8)


@pytest.mark.gpu
def test_train_on_gpu(gpu_device):
    trainer, params = cs.build_trainer("vitl", jnp.bfloat16, 0)
    cs.phase_train(trainer, params, cs.train_batch(2, 8, 518), 2,
                   expect_cudnn=True)
