"""Bring-up plumbing: the compile-cache rule and chip_smoke.py's refusal
to report anything without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax

from sondetpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_cache_env_var_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX's own setting stands."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _updates(monkeypatch)
    assert compile_cache.use_compile_cache() == str(tmp_path)
    assert calls == []


def test_cache_defaults_to_checkout(monkeypatch):
    """Unset: the fixed <checkout>/.jax_cache, never a temp path."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _updates(monkeypatch)
    path = compile_cache.use_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=os.path.join(str(cwd), ".cache"))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _has_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_gpu():
    r = _smoke(REPO)
    assert r.returncode != 0
    assert not _has_ok_line(r.stdout)
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _smoke(tmp_path)
    assert r.returncode != 0
    assert not _has_ok_line(r.stdout)
