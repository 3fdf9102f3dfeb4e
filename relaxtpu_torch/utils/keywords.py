"""The JAX package's keyword names where the port named a parameter
otherwise: ``jax_keywords(df="meta")`` lets a call written for the JAX API
(``split_other(df=...)``) reach the port's parameter (``meta``).  The port's
own names keep working."""

from __future__ import annotations

import functools


def jax_keywords(**names: str):
    """Decorator: each keyword ``jax_name=port_name`` of a call is passed on
    as ``port_name``.  Giving both names of one parameter raises TypeError,
    as a doubled argument does."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            for jax_name, port_name in names.items():
                if jax_name in kwargs:
                    if port_name in kwargs:
                        raise TypeError(f"{fn.__qualname__}() got {jax_name!r} and {port_name!r}, "
                                        "two names of one argument")
                    kwargs[port_name] = kwargs.pop(jax_name)
            return fn(*args, **kwargs)

        return call

    return wrap
