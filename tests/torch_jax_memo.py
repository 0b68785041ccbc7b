"""A per-process memo of the JAX package's parameter-spec tracing, for the
port's tests.

``mlimgsynth_tpu.models.blocks.trace_spec`` runs a whole model abstractly
(``jax.eval_shape``) to learn its parameter names, shapes, kinds and
dtypes.  The JAX session does it at every model load and the tiny
checkpoint writers at every write, and the port's tests load the same tiny
models again and again: about a third of some of their files' time.  The
result is a function of the traced function's code, the values it closes
over (frozen parameter classes, flags, example arrays by shape and dtype)
and the example inputs' shapes and dtypes, so :func:`jax_spec_memo` keeps
each result once per process, for the test module that imports it.  A
function that closes over anything else (an unhashable value) is traced
every time, as before.  Each call gets its own copy of the spec.

Import the fixture into a test module to use it::

    from torch_jax_memo import jax_spec_memo  # noqa: F401
"""
import pytest

from mlimgsynth_tpu.models import blocks as JB

_MEMO = {}


class _Unkeyed(Exception):
    pass


def _key_of(v):
    if isinstance(getattr(v, "shape", None), tuple) and hasattr(v, "dtype"):
        return ("array", v.shape, str(v.dtype))
    try:
        hash(v)
    except TypeError:
        raise _Unkeyed()
    return v


def _key(fn, args):
    code = fn.__code__
    try:
        cells = tuple(_key_of(c.cell_contents)
                      for c in fn.__closure__ or ())
        return (code.co_filename, code.co_firstlineno, code,
                fn.__globals__.get("__name__"), cells,
                tuple(_key_of(a) for a in args))
    except (_Unkeyed, ValueError):
        return None


def _copy(spec):
    return {k: JB.ParamSpec(v.shape, v.kind, v.dtype)
            for k, v in spec.items()}


def memo_trace_spec(fn, *example_args):
    """``trace_spec`` through the memo."""
    key = _key(fn, example_args)
    if key is None:
        return _ORIG(fn, *example_args)
    if key not in _MEMO:
        _MEMO[key] = _copy(_ORIG(fn, *example_args))
    return _copy(_MEMO[key])


_ORIG = JB.trace_spec


@pytest.fixture(autouse=True, scope="module")
def jax_spec_memo():
    """``trace_spec`` memoized for the module's tests, restored after."""
    JB.trace_spec = memo_trace_spec
    try:
        yield
    finally:
        JB.trace_spec = _ORIG
