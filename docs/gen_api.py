"""Generate docs/api.md — the API reference (SURVEY §2 #10: the
reference ships a readthedocs API site; no sphinx/pdoc exists in this
environment, so this ~100-line introspector fills that role).

Usage:  python docs/gen_api.py          (writes docs/api.md)
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODULES = [
    "subpixal_tpu",
    "subpixal_tpu.align",
    "subpixal_tpu.cutout",
    "subpixal_tpu.blot",
    "subpixal_tpu.catalogs",
    "subpixal_tpu.resample",
    "subpixal_tpu.pipeline",
    "subpixal_tpu.utils",
    "subpixal_tpu.testing",
    "subpixal_tpu.ops.correlate",
    "subpixal_tpu.ops.peaks",
    "subpixal_tpu.ops.cutouts",
    "subpixal_tpu.ops.fit",
    "subpixal_tpu.ops.interp",
    "subpixal_tpu.ops.drizzle",
    "subpixal_tpu.ops.blocks",
    "subpixal_tpu.backend",
    "subpixal_tpu.aot",
    "subpixal_tpu.parallel.sharding",
    "subpixal_tpu.parallel.spatial",
    "subpixal_tpu.parallel.distributed",
    "subpixal_tpu.wcs.wcs",
    "subpixal_tpu.wcs.fitswcs",
    "subpixal_tpu.io.fits",
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else "*(undocumented)*"


def _public_names(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        # skip re-exports documented in their home module
        home = getattr(obj, "__module__", mod.__name__)
        if home != mod.__name__ and mod.__name__ != "subpixal_tpu":
            continue
        out.append((n, obj))
    return out


def render() -> str:
    lines = [
        "# API reference",
        "",
        "*Generated by `python docs/gen_api.py` — do not edit by hand.*",
        "",
    ]
    for name in MODULES:
        mod = importlib.import_module(name)
        lines += [f"## `{name}`", ""]
        head = (_doc(mod).split("\n\n")[0]) if mod.__doc__ else ""
        if head:
            lines += [head, ""]
        for sym, obj in _public_names(mod):
            if inspect.isclass(obj):
                lines += [f"### class `{sym}{_sig(obj)}`", "", _doc(obj), ""]
                for mname, meth in inspect.getmembers(obj):
                    if mname.startswith("_"):
                        continue
                    if inspect.isfunction(meth) and meth.__qualname__.startswith(
                            obj.__name__ + "."):
                        lines += [f"#### `{sym}.{mname}{_sig(meth)}`", "",
                                  _doc(meth), ""]
                    elif isinstance(inspect.getattr_static(obj, mname),
                                    property):
                        pdoc = _doc(inspect.getattr_static(obj, mname).fget)
                        lines += [f"#### property `{sym}.{mname}`", "",
                                  pdoc, ""]
            elif callable(obj):
                lines += [f"### `{sym}{_sig(obj)}`", "", _doc(obj), ""]
            else:
                lines += [f"### data `{sym}` = `{obj!r}`", ""]
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "api.md")
    text = render()
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out} ({len(text.splitlines())} lines)")
