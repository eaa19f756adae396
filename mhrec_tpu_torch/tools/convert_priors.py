"""Convert reference-style prior-dictionary modules to mhrec_tpu_torch JSON.

A copy of ``mhrec_tpu/tools/convert_priors.py``.

The reference vendors its human-prior mappings as Python modules exposing a
``tag_to_general`` dict (``code/REC/data/{dataset}_tag_dict.py``,
``*_cluster_dict.py``, ``*_user_cluster_dict.py``; imported dynamically in
dataload.py:349-371). mhrec_tpu_torch treats priors as data (see
``mhrec_tpu_torch/data/tag_dicts``): a JSON file ``{data_path}/{dataset}_{kind}.json``
with the same schema. This tool executes a reference module file and writes
that JSON, so existing prior dictionaries carry over without vendoring code.

Usage::

    python -m mhrec_tpu_torch.tools.convert_priors \
        /path/to/Pixel8M_tag_dict.py  /data/Pixel8M_tag_dict.json

Int keys (cluster ids) become JSON strings; the loader looks tags up by
``str(tag)`` as well, so this is lossless in practice.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def convert(module_path: str, out_path: str) -> dict:
    ns: dict = {}
    with open(module_path) as fh:
        code = fh.read()
    exec(compile(code, module_path, "exec"), ns)  # noqa: S102 - offline tool
    if "tag_to_general" not in ns:
        raise KeyError(f"{module_path} does not define tag_to_general")
    data = ns["tag_to_general"]
    with open(out_path, "w") as fh:
        json.dump(data, fh, indent=1, default=str)
    return data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("module", help="reference *_dict.py module file")
    ap.add_argument("out", help="output JSON path "
                                "({data_path}/{dataset}_{kind}.json)")
    args = ap.parse_args(argv)
    data = convert(args.module, args.out)
    keys = list(data)[:8]
    print(f"wrote {args.out}: top-level keys {keys}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
