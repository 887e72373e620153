"""HF BertModel / BertForQuestionAnswering -> the port's params
(`models/bert.py` layout; the port's `convert/hf_bert.py`).

The load-time half of the reference's BERT example (examples/bert/
weight.py), as the JAX package's: each layer's nn.Linear [out, in]
transposed to [in, out] and stacked over layers. The HF `state_dict()` is
read as torch tensors on its own device, as `convert/hf_families.py`
reads it.
"""

from __future__ import annotations

from ..models.bert import BertConfig
from .hf import _dtype
from .hf_families import _as, _stack


def params_from_hf_bert(hf_model, cfg: BertConfig, dtype=None):
    """For transformers BertModel and Bert*-headed models (the encoder
    lives under `bert.` in a headed model, at the top level in BertModel;
    `qa_outputs` gives the QA head). dtype: a torch dtype or its name
    (default cfg.dtype)."""
    sd = hf_model.state_dict()
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
    e = prefix + "embeddings."
    enc = prefix + "encoder.layer.{}."
    n_l = cfg.num_layers
    dt = _dtype(dtype, cfg)

    def stack(name, transpose=False):
        return _stack(sd, enc + name, n_l, transpose)

    params = {
        "word_emb": sd[e + "word_embeddings.weight"].to(dt),
        "pos_emb": sd[e + "position_embeddings.weight"].to(dt),
        "type_emb": sd[e + "token_type_embeddings.weight"].to(dt),
        "emb_ln_w": sd[e + "LayerNorm.weight"].to(dt),
        "emb_ln_b": sd[e + "LayerNorm.bias"].to(dt),
        "layers": _as({
            "wq": stack("attention.self.query.weight", True),
            "bq": stack("attention.self.query.bias"),
            "wk": stack("attention.self.key.weight", True),
            "bk": stack("attention.self.key.bias"),
            "wv": stack("attention.self.value.weight", True),
            "bv": stack("attention.self.value.bias"),
            "wo": stack("attention.output.dense.weight", True),
            "bo": stack("attention.output.dense.bias"),
            "ln1_w": stack("attention.output.LayerNorm.weight"),
            "ln1_b": stack("attention.output.LayerNorm.bias"),
            "w_fc": stack("intermediate.dense.weight", True),
            "b_fc": stack("intermediate.dense.bias"),
            "w_proj": stack("output.dense.weight", True),
            "b_proj": stack("output.dense.bias"),
            "ln2_w": stack("output.LayerNorm.weight"),
            "ln2_b": stack("output.LayerNorm.bias"),
        }, dt),
    }
    if "qa_outputs.weight" in sd:
        params["qa_w"] = sd["qa_outputs.weight"].t().to(dt).contiguous()
        params["qa_b"] = sd["qa_outputs.bias"].to(dt)
    return params
