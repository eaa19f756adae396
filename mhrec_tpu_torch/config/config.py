"""Cascading-YAML configuration system.

Port of ``mhrec_tpu/config/config.py`` (reference
``code/REC/config/configurator.py``, ``code/run.py:41-104``): an ordered
list of YAML files merged key by key (last wins), missing keys read as
``None``, ``--key value`` CLI overrides with type coercion, and the same
``finalize()`` fix-ups.

The machine with the card has no PyYAML, so ``load_yaml`` reads the subset
of YAML the config files use: ``key: value`` scalars (``null``, booleans,
ints, ``1e-3``-style floats, quoted or bare strings), inline lists, one level
of nested maps, and ``#`` comments. Anything else raises.

A YAML file name resolves as a path first, then under
``mhrec_tpu_torch/config/yamls``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional

_YAML_DIR = os.path.join(os.path.dirname(__file__), "yamls")

# YAML 1.1 scalars as PyYAML resolves them, plus floats without a dot
# ("1e-4"), which the JAX package adds to PyYAML's resolver
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT_RE = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT_RE = re.compile(
    r"""^(?:
        [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN)
    )$""",
    re.X,
)


def _scalar(tok: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if _INT_RE.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT_RE.match(tok):
        low = tok.lower()
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith(".nan"):
            return float("nan")
        return float(tok.replace("_", ""))
    if tok[:1] in "[{&*!|>%@`":
        raise ValueError(f"unsupported YAML scalar {tok!r}")
    return tok


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("["):
        if not tok.endswith("]"):
            raise ValueError(f"unsupported YAML list {tok!r}")
        inner = tok[1:-1].strip()
        return [_scalar(t) for t in inner.split(",")] if inner else []
    return _scalar(tok)


def load_yaml(text: str) -> Dict[str, Any]:
    """Parse the YAML subset described in the module docstring."""
    out: Dict[str, Any] = {}
    parent: Optional[Dict[str, Any]] = None
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, rest = line.strip().partition(":")
        if not sep or not key or (rest and not rest.startswith(" ")):
            raise ValueError(f"unsupported YAML line {raw!r}")
        key = _scalar(key)
        if indent == 0:
            if rest.strip():
                out[key] = _value(rest)
                parent = None
            else:
                parent = out[key] = {}
        elif parent is not None and rest.strip():
            parent[key] = _value(rest)
        else:
            raise ValueError(f"unsupported YAML nesting at {raw!r}")
    return {k: (v if v != {} else None) for k, v in out.items()}


def convert_str(value: str) -> Any:
    """Coerce a CLI string to bool/int/float/None when it parses as one."""
    if not isinstance(value, str):
        return value
    low = value.strip()
    if low.lower() in ("true", "yes"):
        return True
    if low.lower() in ("false", "no"):
        return False
    if low.lower() in ("none", "null"):
        return None
    try:
        return int(low)
    except ValueError:
        pass
    try:
        return float(low)
    except ValueError:
        pass
    return value


def _resolve_path(name: str) -> str:
    if os.path.isfile(name):
        return name
    cand = os.path.join(_YAML_DIR, name)
    if os.path.isfile(cand):
        return cand
    raise FileNotFoundError(f"Config file not found: {name!r} (searched cwd and {_YAML_DIR})")


class Config:
    """Dict-like config; missing keys read as ``None``."""

    def __init__(
        self,
        config_file_list: Optional[Iterable[str]] = None,
        config_dict: Optional[Dict[str, Any]] = None,
        cli_args: Optional[List[str]] = None,
    ):
        self._data: Dict[str, Any] = {}
        for f in config_file_list or []:
            with open(_resolve_path(f)) as fh:
                loaded = load_yaml(fh.read())
            if not isinstance(loaded, dict):
                raise ValueError(f"Config file {f} must contain a mapping")
            self._data.update(loaded)
        if config_dict:
            self._data.update(config_dict)
        if cli_args:
            self.apply_cli_overrides(cli_args)
        self._set_default_parameters()

    # -- CLI overrides -------------------------------------------------------
    def apply_cli_overrides(self, args: List[str]) -> None:
        """Apply ``['--key', 'value', ...]`` pairs (reference run.py:49-69)."""
        if len(args) % 2 != 0:
            raise ValueError(f"CLI overrides must be --key value pairs, got {args}")
        for i in range(0, len(args), 2):
            key = args[i]
            if not key.startswith("--"):
                raise ValueError(f"Expected --key, got {key}")
            key = key[2:]
            raw = args[i + 1]
            if "[" in raw or "{" in raw:
                value = json.loads(raw)
                if isinstance(value, dict):
                    value = {k: convert_str(v) for k, v in value.items()}
                else:
                    value = [convert_str(x) for x in value]
            else:
                value = convert_str(raw)
            if "." in key:
                k1, k2 = key.split(".", 1)
                if not isinstance(self._data.get(k1), dict):
                    self._data[k1] = {}
                self._data[k1][k2] = value
            else:
                self._data[key] = value

    # -- derived defaults ----------------------------------------------------
    def _set_default_parameters(self) -> None:
        d = self._data
        d.setdefault("metrics", ["Recall", "NDCG"])
        d.setdefault("shared_metrics", [])
        d.setdefault("topk", [10])
        if isinstance(d["topk"], int):
            d["topk"] = [d["topk"]]
        d.setdefault("valid_metric", "NDCG@10")
        # smaller-is-better detection mirrors the reference metric registry
        from mhrec_tpu_torch.evaluator.registry import smaller_metrics

        metric_name = str(d["valid_metric"]).split("@")[0].lower()
        d.setdefault("valid_metric_bigger", metric_name not in smaller_metrics)
        d.setdefault("eval_pred_len", 1)
        d.setdefault("pred_len", 1)
        d.setdefault("eval_num_cats", 1)
        d.setdefault("metric_decimal_place", 7)

    def finalize(self) -> "Config":
        """Post-load fixups applied once by the runtime (run.py:90-104)."""
        d = self._data
        mpl = list(d.get("metrics_pred_len_list") or [1])
        if d["eval_pred_len"] not in mpl:
            mpl.append(d["eval_pred_len"])
        half = d["eval_pred_len"] // 2
        if half > 0 and half not in mpl:
            mpl.append(half)
        assert all(isinstance(x, int) and x >= 0 for x in mpl)
        d["metrics_pred_len_list"] = sorted(x - 1 for x in mpl)
        if d.get("loss") not in ("prior",) or not d.get("medusa_num_layers"):
            d["prior_switch"] = None
        if "merrec" in str(d.get("dataset", "")):
            d["category_by"] = "event"
        if d.get("packed_item_tower") is None and d.get("use_ft_flash_attn"):
            # use_ft_flash_attn is the reference's varlen flash-attn fast
            # path for the item tower (hllm.py:56); the TPU moral equivalent
            # is the packed splash-attention tower, so the flag defaults it
            # on unless the dense path is required (images / frozen tower)
            d["packed_item_tower"] = not (
                d.get("use_image") or d.get("use_video")
                or d.get("freeze_item_llm")
            )
        if any(d.get(k) for k in ("video_dir", "video_nframes")) \
                and not d.get("use_video"):
            raise ValueError(
                "video_dir/video_nframes are set but use_video is not — "
                "set use_video: true to enable the static-grid video item "
                "branch (data/vision.py ItemVideoStore)"
            )
        if d.get("use_video"):
            if d.get("use_image"):
                raise ValueError("use_image and use_video are mutually "
                                 "exclusive (one vision span per item)")
            nf = int(d.get("video_nframes", 4) or 4)
            if nf < 2 or nf % 2:
                raise ValueError(
                    f"video_nframes={nf} must be an even count >= 2 "
                    f"(Qwen2-VL temporal patch pairs)"
                )
            d["video_nframes"] = nf
        if d.get("category_by") == "user":
            # user-cluster priors only make sense as an oracle over a single
            # horizon (reference trainer.py:104-105)
            assert d.get("prior_given_at_test") is True and int(
                d.get("given_prior_len") or 0
            ) == 1, (
                "category_by='user' requires prior_given_at_test=True and "
                "given_prior_len=1"
            )
        return self

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data.get(key)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        v = self._data.get(key, default)
        return default if v is None and default is not None else v

    def keys(self):
        return self._data.keys()

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    # categorized pretty-print (reference utils/argument_list.py +
    # configurator __str__: General/Training/Evaluation/Dataset sections,
    # remainder under "Other Hyper Parameters")
    _CATEGORIES = (
        ("General", ("seed", "reproducibility", "state", "model", "data_path",
                     "checkpoint_dir", "show_progress", "config_file",
                     "log_wandb", "save_model_note")),
        ("Training", ("total_iters", "train_batch_size", "optim_args",
                      "eval_interval", "stopping_step", "accumulate_grad",
                      "gradient_checkpointing", "loss", "num_negatives",
                      "sparse_item_adam", "tp_size")),
        ("Evaluation", ("metrics", "topk", "valid_metric",
                        "valid_metric_bigger", "eval_batch_size",
                        "eval_pred_len", "metric_decimal_place",
                        "split_mode", "suppress_history")),
        ("Dataset", ("dataset", "text_path", "MAX_TEXT_LENGTH",
                     "MAX_ITEM_LIST_LENGTH", "MAX_ITEM_LIST_LENGTH_TEST",
                     "min_seq_len", "text_keys", "item_prompt",
                     "tag_version", "eval_num_cats")),
    )

    def format_categorized(self) -> str:
        lines = []
        seen = set()
        for title, keys in self._CATEGORIES:
            lines.append(f"{title} Hyper Parameters:")
            for k in keys:
                if k in self._data:
                    lines.append(f"  {k} = {self._data[k]}")
                    seen.add(k)
            lines.append("")
        rest = [k for k in sorted(self._data) if k not in seen]
        if rest:
            lines.append("Other Hyper Parameters:")
            lines.extend(f"  {k} = {self._data[k]}" for k in rest)
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"Config({len(self._data)} keys)"
