"""Human-prior dictionary registry.

The reference vendors dataset-specific prior mappings as Python modules
(``REC/data/{dataset}_tag_dict.py`` / ``*_cluster_dict.py``, imported
dynamically in dataload.py:349-371). Here priors are data, not code: they are
loaded, in order of precedence, from

1. a JSON file ``{data_path}/{dataset}_{kind}.json``
2. a Python module ``mhrec_tpu_torch.data.tag_dicts.{dataset}_{kind}`` exposing
   ``tag_to_general`` (same schema as the reference modules)

where ``kind`` is ``tag_dict``, ``cluster_dict`` or ``user_cluster_dict``.

Schema (item/user kinds)::

    {"<tag_version>": {"category_counts": {cat: count, ...},
                        "tag_to_category": {tag: [cat, ...], ...}}}

Schema (event kind)::

    {"category_counts": {cat: count, ...}, "category_to_int": {cat: int, ...}}
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any, Dict


def load_prior_dict(data_path: str, dataset: str, kind: str) -> Dict[str, Any]:
    json_path = os.path.join(data_path or ".", f"{dataset}_{kind}.json")
    if os.path.isfile(json_path):
        with open(json_path) as fh:
            return json.load(fh)
    try:
        mod = importlib.import_module(f"mhrec_tpu_torch.data.tag_dicts.{dataset}_{kind}")
        return mod.tag_to_general
    except ImportError:
        raise FileNotFoundError(
            f"No prior dictionary for dataset={dataset!r} kind={kind!r}: "
            f"looked for {json_path} and module mhrec_tpu_torch.data.tag_dicts.{dataset}_{kind}"
        )
