"""ParmParse-compatible input-file reader (the port's own copy of
`somar_tpu.config.parmparse`, pure Python).

`key = v1 v2 ...` lines with `#` comments, namespaced keys
(`amr.maxlevel`), later assignments override earlier ones, and
command-line `key=value` overrides.  The reference's input files parse
unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class ParmParse:
    def __init__(self, table: Optional[Dict[str, List[str]]] = None):
        self._table: Dict[str, List[str]] = table or {}

    # ------------------------------------------------------------ loading
    @classmethod
    def from_file(cls, path: str, overrides: Sequence[str] = ()) -> "ParmParse":
        pp = cls()
        with open(path) as f:
            for line in f:
                pp._parse_line(line)
        for ov in overrides:
            pp._parse_line(ov)
        return pp

    @classmethod
    def from_string(cls, text: str) -> "ParmParse":
        pp = cls()
        for line in text.splitlines():
            pp._parse_line(line)
        return pp

    def _parse_line(self, line: str):
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
            return
        key, _, val = line.partition("=")
        self._table[key.strip()] = val.split()

    # ------------------------------------------------------------ queries
    def contains(self, key: str) -> bool:
        return key in self._table

    def _get(self, key: str, default, cast, n: Optional[int] = None):
        if key not in self._table:
            if default is _REQUIRED:
                raise KeyError(f"required input '{key}' not found")
            return default
        # lenient token scan: stop at the first non-castable token (some
        # shipped inputs carry un-commented default annotations like "[1]")
        vals = []
        for v in self._table[key]:
            try:
                vals.append(cast(v))
            except ValueError:
                break
        if not vals:
            if default is _REQUIRED:
                raise KeyError(f"required input '{key}' has no usable value")
            return default
        if n is None:
            return vals[0] if len(vals) == 1 else vals
        if len(vals) < n:
            # pad short vectors (e.g. a scalar tidalU0 in a 3D run) with
            # their last value, matching the forgiving reads of the
            # reference's ProblemContext
            vals = vals + [vals[-1]] * (n - len(vals))
        return vals[:n]

    def get_int(self, key, default=None):
        return self._get(key, default, int)

    def get_real(self, key, default=None):
        return self._get(key, default, float)

    def get_bool(self, key, default=None):
        v = self._get(key, default, int)
        return bool(v) if v is not default else default

    def get_str(self, key, default=None):
        return self._get(key, default, str)

    def get_int_vect(self, key, n, default=None):
        v = self._get(key, default, int, n)
        if v is default:
            return default
        return tuple(v if isinstance(v, list) else [v])

    def get_real_vect(self, key, n, default=None):
        v = self._get(key, default, float, n)
        if v is default:
            return default
        return tuple(v if isinstance(v, list) else [v])

    def require_int(self, key):
        return self._get(key, _REQUIRED, int)

    def require_real(self, key):
        return self._get(key, _REQUIRED, float)

    def require_int_vect(self, key, n):
        return tuple(self._get(key, _REQUIRED, int, n))

    def require_real_vect(self, key, n):
        return tuple(self._get(key, _REQUIRED, float, n))


class _Required:
    pass


_REQUIRED = _Required()
