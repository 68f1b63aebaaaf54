"""Typed parameter DSL for pipeline stages (own copy of the subset of
``mmlspark_tpu.core.params`` that the port's stages use).

Every knob on a stage is a :class:`Param` descriptor with a default, a doc
string, an optional type and an optional validator; :class:`Params` gives
a stage its value store and class-level introspection.
"""

from __future__ import annotations

from typing import Any, Callable


class ParamValidationError(ValueError):
    """Raised when a param value fails its type or validator check."""


class Param:
    """A typed, validated, documented parameter declared on a stage class::

        class MyStage(Transformer):
            n = Param(default=8, doc="batch size", type_=int,
                      validator=Param.gt(0))
    """

    __slots__ = ("name", "default", "doc", "type_", "validator",
                 "is_complex")

    def __init__(self, default: Any = None, doc: str = "",
                 type_: type | tuple[type, ...] | None = None,
                 validator: Callable[[Any], bool] | None = None,
                 is_complex: bool = False):
        self.name: str | None = None  # filled by __set_name__
        self.default = default
        self.doc = doc
        self.type_ = type_
        self.validator = validator
        # complex params hold values that are not plain JSON (models)
        self.is_complex = is_complex

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name

    def __get__(self, obj: Any, objtype: type | None = None) -> Any:
        if obj is None:
            return self
        return obj.get(self.name)

    def __set__(self, obj: Any, value: Any) -> None:
        obj.set(**{self.name: value})

    def validate(self, value: Any) -> Any:
        """Validate (and lightly coerce) a candidate value; return it."""
        if value is None:
            return value
        if self.type_ is not None:
            if self.type_ is float and isinstance(value, int) \
                    and not isinstance(value, bool):
                value = float(value)
            if self.type_ is int and isinstance(value, bool):
                raise ParamValidationError(
                    f"param {self.name!r}: got bool where int expected")
            if not isinstance(value, self.type_):
                raise ParamValidationError(
                    f"param {self.name!r}: expected {self.type_}, "
                    f"got {type(value).__name__} ({value!r})")
        if self.validator is not None and not self.validator(value):
            raise ParamValidationError(
                f"param {self.name!r}: value {value!r} outside domain "
                f"({getattr(self.validator, '_doc', 'validator failed')})")
        return value

    def __repr__(self) -> str:
        return (f"Param({self.name!r}, default={self.default!r}, "
                f"doc={self.doc!r})")

    @staticmethod
    def gt(lo: float) -> Callable[[Any], bool]:
        def check(v: Any) -> bool:
            return v > lo
        check._doc = f"> {lo}"  # type: ignore[attr-defined]
        return check

    @staticmethod
    def ge(lo: float) -> Callable[[Any], bool]:
        def check(v: Any) -> bool:
            return v >= lo
        check._doc = f">= {lo}"  # type: ignore[attr-defined]
        return check


class Params:
    """Base class giving a stage its param store and introspection surface.

    Values live in ``self._values``; unset params fall back to the
    class-level default."""

    def __init__(self, **kwargs: Any):
        self._values: dict[str, Any] = {}
        self.set(**kwargs)

    @classmethod
    def params(cls) -> dict[str, Param]:
        cached = cls.__dict__.get("_params_cache")
        if cached is not None:
            return cached
        out: dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    out[k] = v
        cls._params_cache = out
        return out

    @classmethod
    def param(cls, name: str) -> Param:
        p = cls.params().get(name)
        if p is None:
            raise KeyError(f"{cls.__name__} has no param {name!r}")
        return p

    def get(self, name: str) -> Any:
        p = type(self).param(name)
        return self._values.get(name, p.default)

    def set(self, **kwargs: Any) -> "Params":
        """Set params by keyword; validates each. Returns self (chainable)."""
        declared = type(self).params()
        for name, value in kwargs.items():
            p = declared.get(name)
            if p is None:
                raise KeyError(
                    f"{type(self).__name__} has no param {name!r}; "
                    f"available: {sorted(declared)}")
            self._values[name] = p.validate(value)
        return self

    def _simple_param_values(self) -> dict[str, Any]:
        """Explicitly-set, JSON-representable params (for persistence)."""
        declared = type(self).params()
        return {k: v for k, v in self._values.items()
                if not declared[k].is_complex}

    def _complex_param_values(self) -> dict[str, Any]:
        declared = type(self).params()
        return {k: v for k, v in self._values.items()
                if declared[k].is_complex}

    def __repr__(self) -> str:
        declared = type(self).params()
        sets = ", ".join(f"{k}={v!r}" for k, v in self._values.items()
                         if not declared[k].is_complex)
        return f"{type(self).__name__}({sets})"
