"""Every public name of each module of the JAX package's host surface exists
in the port's counterpart: the names of `dir()` without a leading
underscore that are not modules (the reference's `os`, imported for JAX's
compilation cache, and an unused `np` in parallel/index.py are modules,
not API). The only names left out are JAX's own, listed in JAX_OWN with
the port's counterpart, and the names that a reference module imports and
never uses, listed in UNUSED_IMPORTS: they are not API either."""
import importlib
import inspect
import types

import pytest

MODULES = ["", "checksum.crc32", "checksum.adler32", "utils.bitwriter",
           "stream.inflate", "stream.api", "stream.gzfile", "parallel.index",
           "pyzlib", "zng", "compat", "cli.minigzip", "cli.minideflate"]

# the reference's names that run JAX on the TPU -> the port's counterpart
JAX_OWN = {"": {"compress_tpu": "compress_cuda",
                "decompress_tpu": "decompress_cuda"},
           "parallel.index": {"decompress_indexed_tpu":
                              "decompress_indexed_cuda"}}

# names the reference module imports and never uses
UNUSED_IMPORTS = {"parallel.index": {"Inflate", "STREAM_END"},
                  "stream.api": {"adler32_combine", "BufError", "NEED_INPUT"}}


def _public(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def _load(package: str, name: str):
    return importlib.import_module(package + ("." + name if name else ""))


@pytest.mark.parametrize("name", MODULES)
def test_port_has_every_public_name(name):
    ref = _load("zlibng_tpu", name)
    port = _load("zlibng_tpu_torch", name)
    own = JAX_OWN.get(name, {})
    missing = sorted(_public(ref) - _public(port) - set(own)
                     - UNUSED_IMPORTS.get(name, set()))
    assert not missing, missing
    for jax_name, counterpart in own.items():
        assert callable(getattr(ref, jax_name))
        assert callable(getattr(port, counterpart))
    # what both have is the same kind of thing: class, callable or value
    for n in _public(ref) & _public(port):
        r, p = getattr(ref, n), getattr(port, n)
        assert isinstance(r, type) == isinstance(p, type), n
        assert callable(r) == callable(p), n
        if isinstance(r, (int, str, bytes)) and not isinstance(r, bool):
            assert r == p, n


# the port's additions to a reference signature: (module, name) -> params
ADDED_PARAMS = {("cli.minigzip", "compress_file"): ["device"]}

# reference parameters that are stored and never read, wherever the
# function is imported: the port leaves them out
DEAD_PARAMS = {"RawInflater": ["strict_dist"],
               "RawInflater.__init__": ["strict_dist"],
               "inflate_raw": ["strict_dist"]}


def _params(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):     # a builtin without a signature
        return None
    return [(p.name, p.default) for p in sig.parameters.values()]


@pytest.mark.parametrize("name", MODULES)
def test_port_signatures_match_reference(name):
    """Identical calls reach both packages: every function and method that
    both modules have takes the same parameters with the same defaults (the
    port may only add ADDED_PARAMS, after the reference's, and leave out
    DEAD_PARAMS)."""
    ref = _load("zlibng_tpu", name)
    port = _load("zlibng_tpu_torch", name)
    for n in sorted(_public(ref) & _public(port)):
        r, p = getattr(ref, n), getattr(port, n)
        pairs = [(n, r, p)]
        if isinstance(r, type):
            pairs += [(f"{n}.{m}", getattr(r, m), getattr(p, m))
                      for m in vars(r) if callable(getattr(r, m))
                      and (not m.startswith("_") or m == "__init__")]
        for label, rf, pf in pairs:
            if not callable(rf) or _params(rf) is None:
                continue
            got = _params(pf)
            added = ADDED_PARAMS.get((name, label), [])
            dead = DEAD_PARAMS.get(label, [])
            assert [a for a in got if a[0] not in added] == \
                [a for a in _params(rf) if a[0] not in dead], label
