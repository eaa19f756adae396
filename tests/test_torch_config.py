"""The port's config layer against the JAX package's.

The port reads its YAMLs with its own loader for the subset the files use
(the machine with the card has no PyYAML); it must give what PyYAML, with
the JAX package's float resolver, gives on every copied file. ``Config``
must give the same finalised dict as ``mhrec_tpu.config.Config``.
"""

import os

import pytest
import torch
import yaml

from mhrec_tpu.config import Config as JaxConfig
from mhrec_tpu.config.config import _ConfigLoader
from mhrec_tpu_torch.config import Config, load_yaml
from mhrec_tpu_torch.config.config import _YAML_DIR

torch.set_num_threads(2)

YAMLS = ["overall/ID.yaml", "IDNet/hstu.yaml", "IDNet/hstu-size1.yaml",
         "IDNet/hstu-size2.yaml", "IDNet/hstu-size3.yaml", "IDNet/hstu-size4.yaml"]
FILES = ["IDNet/hstu-size4.yaml", "overall/ID.yaml", "IDNet/hstu.yaml"]

# the paper's headline serving run (reproduce/HSTU-Pixel8M-prior.sh)
HEADLINE = dict(
    MAX_ITEM_LIST_LENGTH=50, loss="prior", eval_num_cats=8, num_prior_head=8,
    num_segment_head=4, head_interaction="additive", medusa_num_layers=1,
    prior_switch="in", use_prior_switch_test=True, eval_pred_len=8, pred_len=8,
    topk=[5, 10, 50, 200], val_only=True,
)


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_subset_loader_matches_pyyaml(name):
    with open(os.path.join(_YAML_DIR, name)) as fh:
        text = fh.read()
    assert load_yaml(text) == (yaml.load(text, Loader=_ConfigLoader) or {})


def test_yaml_subset_loader_scalars():
    text = ("a: 1e-3\nb: -2\nc: null\nd: true\ne: 'x # y'  # note\nf: [1, 2.5, z]\n"
            "g:\n  h: 3\n  i: off\nj: .5\nk: ~\n")
    assert load_yaml(text) == yaml.load(text, Loader=_ConfigLoader)


@pytest.mark.parametrize("text", ["- a\n- b\n", "a:\n  b:\n    c: 1\n", "a: {b: 1}\n", "a b\n"])
def test_yaml_subset_loader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        load_yaml(text)


def test_config_matches_jax_config():
    cli = ["--topk", "[5,10,50,200]", "--optim_args.learning_rate", "1e-4",
           "--eval_batch_size", "1024", "--seed", "0"]
    ours = Config(config_file_list=FILES, config_dict=dict(HEADLINE), cli_args=cli).finalize()
    ref = JaxConfig(config_file_list=FILES, config_dict=dict(HEADLINE), cli_args=cli).finalize()
    assert ours.as_dict() == ref.as_dict()
    assert ours["n_layers"] == 16 and ours["hstu_embedding_size"] == 1024
    assert ours["metrics_pred_len_list"] == [0, 3, 7]
    assert ours["prior_switch"] == "in" and ours["optim_args"]["learning_rate"] == 1e-4
    assert ours["missing_key"] is None
