"""Package set-up (compile cache) and chip_smoke.py's device gate."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(args, env_set=None, env_drop=()):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env.update(env_set or {})
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, *args], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at the fixed in-checkout path that .gitignore lists."""
    code = ("import jax, orb_slam2_comment_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    if from_env:
        want = str(tmp_path / "cc")
        r = _python(["-c", code], {"JAX_COMPILATION_CACHE_DIR": want})
    else:
        want = os.path.join(REPO, ".jax_cache")
        r = _python(["-c", code], env_drop=("JAX_COMPILATION_CACHE_DIR",))
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


def test_chip_smoke_fails_without_gpu():
    """On the CPU the smoke run stops at its device phase: non-zero exit
    and no result line."""
    r = _python(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr
