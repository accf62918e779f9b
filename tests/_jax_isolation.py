"""Adapts ``jax.monitoring`` duration listeners that take no keyword
arguments to this jax, for every test in the worker process.

The JAX package's recompile watcher (``obs/recompile.py``) registers
``_on_event(key, dur)``, but this jax passes keyword arguments
(``fun_name=...``) with its compile events, so once the watcher is on,
every later compile in that process raises ``TypeError`` inside
``jax.monitoring``.  ``jax.monitoring`` has no way to take a listener back,
so the first test file that starts a watcher breaks every JAX test that
runs after it in the same worker.

Importing this module (the port's parity tests do, so every worker imports
it while collecting) wraps such listeners, already registered or
registered later, in an adapter that drops the keyword arguments.  A
listener that accepts ``**kwargs`` is registered as it is.  The adapter
compares equal to the listener it wraps, so ``unregister`` still finds it.
"""

import inspect


class _DropKwargs:
    def __init__(self, cb):
        self.cb = cb

    def __call__(self, event, duration, **kwargs):
        return self.cb(event, duration)

    def __eq__(self, other):
        return other is self or other == self.cb

    def __hash__(self):
        return hash(self.cb)


def _adapt(cb):
    if isinstance(cb, _DropKwargs):
        return cb
    try:
        params = inspect.signature(cb).parameters.values()
    except (TypeError, ValueError):  # no signature to read: leave it
        return cb
    if any(p.kind is p.VAR_KEYWORD for p in params):
        return cb
    return _DropKwargs(cb)


def _install():
    try:
        import jax.monitoring as public
        from jax._src import monitoring
        listeners = monitoring._event_duration_secs_listeners
        register = monitoring.register_event_duration_secs_listener
    except (ImportError, AttributeError):  # another jax layout: nothing to do
        return
    if getattr(register, "_adapts_kwargs", False):
        return
    listeners[:] = [_adapt(cb) for cb in listeners]

    def register_event_duration_secs_listener(callback):
        register(_adapt(callback))

    register_event_duration_secs_listener._adapts_kwargs = True
    monitoring.register_event_duration_secs_listener = register_event_duration_secs_listener
    public.register_event_duration_secs_listener = register_event_duration_secs_listener


_install()
