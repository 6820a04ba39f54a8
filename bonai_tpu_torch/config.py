"""Python-file config system with ``_base_`` inheritance.

The port's own copy of ``bonai_tpu/config.py``: it reads the same
``configs/`` tree with the same semantics (mmcv ``Config.fromfile`` and
the ``_base_`` composition of e.g.
``configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py``):

- a config is a python file executed in an isolated namespace; every
  module-level name that does not start with ``_`` becomes a config key
- ``_base_ = [...]`` recursively loads and dict-merges parent configs
- child dicts merge key-wise into parents; ``_delete_: True`` replaces the
  parent dict wholesale instead of merging
- ``merge_from_dict`` supports dotted-key CLI overrides (``--options a.b=c``)
- attribute access (``cfg.model.backbone.depth``) via ``ConfigDict``
"""

from __future__ import annotations

import ast
import copy
import os
import os.path as osp
import tempfile
import types

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"
RESERVED_KEYS = ("filename", "text")


class ConfigDict(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, name):
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'") from None
        return value

    def __setattr__(self, name, value):
        self[name] = wrap_config(value)

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setitem__(self, key, value):
        super().__setitem__(key, wrap_config(value))

    def __deepcopy__(self, memo):
        other = ConfigDict()
        memo[id(self)] = other
        for k, v in self.items():
            dict.__setitem__(other, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return other

    def copy(self):
        return copy.deepcopy(self)

    def get(self, key, default=None):
        return self[key] if key in self else default

    def pop(self, key, *args):
        return super().pop(key, *args)

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]


def wrap_config(value):
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, dict):
        return ConfigDict({k: wrap_config(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        wrapped = [wrap_config(v) for v in value]
        return type(value)(wrapped) if isinstance(value, tuple) else wrapped
    return value


def merge_dict(base, override):
    """Merge ``override`` into ``base`` (returns a new dict).

    Matches reference merge semantics: nested dicts merge key-wise unless the
    override dict carries ``_delete_: True``; non-dict values replace.
    """
    merged = copy.deepcopy(base)
    for key, value in override.items():
        if (isinstance(value, dict) and key in merged
                and isinstance(merged[key], dict)
                and not value.pop(DELETE_KEY, False)):
            merged[key] = merge_dict(merged[key], value)
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != DELETE_KEY}
            merged[key] = copy.deepcopy(value)
    return merged


def _exec_pyfile(filename):
    """Execute a config .py file, returning its module-level dict."""
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f"config file not found: {filename}")
    with open(filename, encoding="utf-8") as f:
        content = f.read()
    try:
        ast.parse(content)
    except SyntaxError as e:
        raise SyntaxError(f"config file {filename} is not valid python: {e}") from e
    module = types.ModuleType("_bonai_tpu_torch_cfg")
    module.__file__ = filename
    code = compile(content, filename, "exec")
    exec(code, module.__dict__)
    cfg = {
        k: v for k, v in module.__dict__.items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
        and not isinstance(v, types.FunctionType) and not isinstance(v, type)
    }
    return cfg, content


def _load_with_base(filename):
    cfg, text = _exec_pyfile(filename)
    cfg_dir = osp.dirname(osp.abspath(osp.expanduser(filename)))
    base = cfg.pop(BASE_KEY, None)
    if base is None:
        return cfg, text
    if isinstance(base, str):
        base = [base]
    merged = {}
    texts = []
    for b in base:
        b_cfg, b_text = _load_with_base(osp.join(cfg_dir, b))
        dup = set(merged) & set(b_cfg)
        if dup:
            raise KeyError(f"duplicate keys {dup} between base files of {filename}")
        merged.update(b_cfg)
        texts.append(b_text)
    merged = merge_dict(merged, cfg)
    texts.append(text)
    return merged, "\n".join(texts)


def _pretty(obj, indent=0):
    pad = " " * indent
    if isinstance(obj, dict):
        if not obj:
            return "dict()"
        items = []
        for k, v in obj.items():
            key = k if isinstance(k, str) and k.isidentifier() else repr(k)
            items.append(f"{pad}    {key}={_pretty(v, indent + 4)}")
        return "dict(\n" + ",\n".join(items) + f"\n{pad})"
    if isinstance(obj, (list, tuple)):
        inner = ", ".join(_pretty(v, indent) for v in obj)
        return f"[{inner}]" if isinstance(obj, list) else f"({inner},)"
    return repr(obj)


class Config:
    """A config object backed by a :class:`ConfigDict`."""

    @staticmethod
    def fromfile(filename):
        cfg_dict, text = _load_with_base(filename)
        return Config(cfg_dict, filename=filename, text=text)

    @staticmethod
    def fromstring(cfg_str, file_format=".py"):
        with tempfile.NamedTemporaryFile(
                "w", suffix=file_format, delete=False) as f:
            f.write(cfg_str)
            path = f.name
        try:
            return Config.fromfile(path)
        finally:
            os.unlink(path)

    def __init__(self, cfg_dict=None, filename=None, text=None):
        cfg_dict = {} if cfg_dict is None else cfg_dict
        for key in RESERVED_KEYS:
            if key in cfg_dict:
                raise KeyError(f"{key} is reserved in Config")
        object.__setattr__(self, "_cfg_dict", wrap_config(dict(cfg_dict)))
        object.__setattr__(self, "_filename", filename)
        object.__setattr__(self, "_text", text or "")

    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    @property
    def pretty_text(self):
        lines = []
        for k, v in self._cfg_dict.items():
            lines.append(f"{k} = {_pretty(v)}")
        return "\n".join(lines)

    def dump(self, file=None):
        if file is None:
            return self.pretty_text
        with open(file, "w", encoding="utf-8") as f:
            f.write(self.pretty_text + "\n")
        return None

    def merge_from_dict(self, options):
        """Merge dotted-key overrides, e.g. ``{'model.backbone.depth': 101}``."""
        option_cfg = {}
        for full_key, value in options.items():
            d = option_cfg
            keys = full_key.split(".")
            for sub in keys[:-1]:
                d = d.setdefault(sub, {})
            d[keys[-1]] = value
        merged = merge_dict(dict(self._cfg_dict), option_cfg)
        object.__setattr__(self, "_cfg_dict", wrap_config(merged))

    def __reduce__(self):
        # pickled for the ranks that ``parallel.launch`` spawns
        return Config, (self._cfg_dict, self._filename, self._text)

    # -- mapping / attribute protocol ------------------------------------
    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = value

    def __getitem__(self, key):
        return self._cfg_dict[key]

    def __setitem__(self, key, value):
        self._cfg_dict[key] = value

    def __contains__(self, key):
        return key in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self):
        return len(self._cfg_dict)

    def __repr__(self):
        return f"Config (path: {self._filename}): {self._cfg_dict!r}"

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def values(self):
        return self._cfg_dict.values()

    def copy(self):
        return Config(copy.deepcopy(dict(self._cfg_dict)),
                      filename=self._filename, text=self._text)
