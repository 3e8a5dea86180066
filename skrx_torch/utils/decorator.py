"""Decorators: argument types asserted at call time, and wall-clock timing
(the port's own copy of ``skrx.utils.decorator``)."""
import functools
import inspect
import time

__all__ = ["typeassert", "timer"]


def typeassert(*type_args, **type_kwargs):
    """Raise TypeError when an argument is not of its declared type (None
    passes)::

        @typeassert(x=int, y=(int, float))
        def f(x, y): ...
    """

    def decorate(func):
        sig = inspect.signature(func)
        bound_types = sig.bind_partial(*type_args, **type_kwargs).arguments

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            for name, value in sig.bind(*args, **kwargs).arguments.items():
                if name in bound_types and value is not None \
                        and not isinstance(value, bound_types[name]):
                    raise TypeError(
                        f"Argument '{name}' must be {bound_types[name]}, "
                        f"got {type(value).__name__}")
            return func(*args, **kwargs)

        return wrapper

    return decorate


def timer(func):
    """Print the wall time of each call."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        result = func(*args, **kwargs)
        print(f"{func.__name__} took {time.perf_counter() - start:.4f}s")
        return result

    return wrapper
