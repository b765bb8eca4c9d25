"""Native host data plane (SURVEY.md section 2.4).

The C extension (_hotpath.c) is compiled ON FIRST IMPORT with the
toolchain baked into the image (g++ against the running interpreter's
headers -- no pip, no pybind11). A build or import failure degrades
silently to the pure-Python implementations in api/selectors.py, which
carry identical semantics (differentially fuzzed in
tests/test_native_selectors.py).
"""

from __future__ import annotations

import logging
import os
import subprocess
import sysconfig

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_hotpath.c")
_SO = os.path.join(
    _DIR, "_hotpath" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so")
)


def _build() -> bool:
    include = sysconfig.get_paths()["include"]
    tmp = _SO + f".build.{os.getpid()}"
    for cc in ("g++", "cc", "gcc"):
        try:
            subprocess.run(
                [
                    cc, "-O2", "-shared", "-fPIC", "-x", "c",
                    f"-I{include}", _SRC, "-o", tmp,
                ],
                check=True,
                capture_output=True,
                timeout=120,
            )
            # atomic publish: concurrent importers never dlopen a
            # half-written binary
            os.replace(tmp, _SO)
            return True
        except FileNotFoundError:
            continue
        except Exception as e:  # noqa: BLE001 - try the next compiler
            logger.debug("native build with %s failed: %s", cc, e)
            continue
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    return False


hotpath = None
try:
    if not os.path.exists(_SO) or (
        os.path.getmtime(_SO) < os.path.getmtime(_SRC)
    ):
        _build()
    # gate the import on the binary being CURRENT: importing a stale .so
    # after a failed rebuild would silently run old matching semantics
    if os.path.exists(_SO) and (
        os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
    ):
        from kubernetes_tpu_torch.native import _hotpath as hotpath  # type: ignore
except Exception:  # noqa: BLE001 - pure-Python fallback
    hotpath = None

#: single source of truth for the native clone fast path: callers do
#: ``from kubernetes_tpu_torch.native import cow_clone`` and fall back to
#: copy.copy chains when it is None (build/import failure, stale .so)
cow_clone = getattr(hotpath, "cow_clone", None)
#: one-call commit-path loops (see _hotpath.c "bulk commit spine")
assume_clones = getattr(hotpath, "assume_clones", None)
bind_assumed_bulk = getattr(hotpath, "bind_assumed_bulk", None)
commit_gather = getattr(hotpath, "commit_gather", None)

# -- the ingest plane (see _hotpath.c "ingest spine") ---------------------
#
# Gated separately from the commit-path loops by KTPU_NATIVE_INGEST
# (default on): =0 forces the pure-Python twins at every ingest call
# site, the differential-test and A/B-bench switch. The env var is read
# PER CALL of ``ingest_fn`` (cheap: once per frame/batch, not per pod)
# so tests can flip it without re-importing the world.

_INGEST_FNS = {
    name: getattr(hotpath, name, None)
    for name in (
        "ingest_decode", "ingest_apply", "ingest_stamp",
        "pack_gather", "queue_shape", "mirror_scatter",
    )
}


def ingest_on() -> bool:
    """True when the native ingest plane is not disabled by env."""
    return os.environ.get("KTPU_NATIVE_INGEST", "1") not in ("0", "false")


def ingest_native_active() -> bool:
    """True when ingest calls will actually run the C path (env on AND
    the extension built) -- the machine-readable bench label."""
    return ingest_on() and _INGEST_FNS.get("ingest_apply") is not None


def ingest_fn(name: str):
    """(callable_or_None, expected): the native ingest entry point, or
    None with ``expected`` telling the caller whether running the
    Python twin counts as a FALLBACK (native wanted but unavailable --
    the caller books scheduler_ingest_native_fallbacks_total) or as the
    configured path (KTPU_NATIVE_INGEST=0)."""
    if not ingest_on():
        return None, False
    return _INGEST_FNS.get(name), True
