"""Caffe prototxt config adapter.

Drop-in migration path from the reference's configuration surface: parse the
``DataGeneration`` layer block of a Caffe train.prototxt (reference:
example-prototxt/train.prototxt, proto schema src/caffe/proto/caffe.proto:6-12)
into a :class:`flowgen.DataGenConfig`. Thread-count fields are accepted and
ignored (generation is a single fused device program); unknown layers/fields
are skipped.

This is a small hand-rolled parser for the prototxt text format subset that
Caffe layer definitions use (nested ``name { ... }`` blocks and ``key: value``
scalars) — no protobuf runtime involvement needed.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from ..config import DataGenConfig

_TOKEN = re.compile(r"[{}]|\"(?:[^\"\\]|\\.)*\"|[^\s{}:]+|:")


def _tokenize(text: str) -> List[str]:
    # strip comments
    lines = []
    for line in text.splitlines():
        for marker in ("#",):
            pos = line.find(marker)
            if pos >= 0:
                line = line[:pos]
        lines.append(line)
    return _TOKEN.findall("\n".join(lines))


def _parse_block(tokens: List[str], pos: int) -> Tuple[Dict[str, Any], int]:
    """Parse a message body until the matching '}' (or end of input).
    Repeated fields accumulate into lists."""
    out: Dict[str, Any] = {}

    def put(key, value):
        if key in out:
            if not isinstance(out[key], list):
                out[key] = [out[key]]
            out[key].append(value)
        else:
            out[key] = value

    n = len(tokens)
    while pos < n:
        tok = tokens[pos]
        if tok == "}":
            return out, pos + 1
        key = tok
        pos += 1
        if pos < n and tokens[pos] == ":":
            pos += 1
            val = tokens[pos]
            pos += 1
            put(key, _coerce(val))
        elif pos < n and tokens[pos] == "{":
            sub, pos = _parse_block(tokens, pos + 1)
            put(key, sub)
        else:
            raise ValueError(f"malformed prototxt near token {key!r}")
    return out, pos


def _coerce(val: str):
    if val.startswith('"'):
        return val[1:-1]
    if val in ("true", "false"):
        return val == "true"
    try:
        return int(val)
    except ValueError:
        pass
    try:
        return float(val)
    except ValueError:
        return val


def parse_prototxt(text: str) -> Dict[str, Any]:
    """Parse prototxt text into nested dicts (repeated fields become lists)."""
    out, _ = _parse_block(_tokenize(text), 0)
    return out


def config_from_prototxt(text: str, **overrides) -> DataGenConfig:
    """Build a DataGenConfig from the first ``DataGeneration`` layer found.

    Recognized fields: data_param.batch_size / prefetch;
    data_generation_param.mode / texture_dbases / use_antialiasing.
    ``first_level_threads`` / ``second_level_threads`` have no TPU analog and
    are ignored. Keyword ``overrides`` win over file values.
    """
    msg = parse_prototxt(text)
    layers = msg.get("layer", [])
    if not isinstance(layers, list):
        layers = [layers]
    layer = next(
        (l for l in layers if l.get("type") == "DataGeneration"), None
    )
    if layer is None:
        raise ValueError("no DataGeneration layer found in prototxt")

    kw: Dict[str, Any] = {}
    dp = layer.get("data_param", {})
    if "batch_size" in dp:
        kw["batch_size"] = int(dp["batch_size"])
    if "prefetch" in dp:
        kw["prefetch"] = int(dp["prefetch"])
    gp = layer.get("data_generation_param", {})
    if "mode" in gp:
        kw["mode"] = int(gp["mode"])
    if "use_antialiasing" in gp:
        kw["use_antialiasing"] = bool(gp["use_antialiasing"])
    if "texture_dbases" in gp:
        dbs = gp["texture_dbases"]
        kw["texture_dbases"] = tuple(dbs) if isinstance(dbs, list) else (dbs,)
    # The reference layer emits Caffe blobs: CHW float, BGR channel order.
    kw.setdefault("layout", "nchw")
    kw.setdefault("channel_order", "bgr")
    kw.update(overrides)
    return DataGenConfig(**kw)


def load_config(path: str, **overrides) -> DataGenConfig:
    with open(path) as f:
        return config_from_prototxt(f.read(), **overrides)
