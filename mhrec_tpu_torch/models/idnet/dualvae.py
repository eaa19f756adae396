"""DualVAE — sequential dual-VAE baseline with aspect disentanglement (port
of ``mhrec_tpu/models/idnet/dualvae.py``).

Reference ``code/REC/model/IDNet/dualvae.py``: items are projected into A
aspect-specific K-dim latents, weighted by softmax aspect probabilities
against learned topic prototypes; a *causal* attention-pooled prefix summary
per aspect feeds a VAE inference net (mean, softplus standard deviation;
reparameterised in training with noise from the step's generator, the mean
at evaluation); losses: masked causal NCE over aspect-weighted cosine
interactions, a KL term annealed linearly over ``batch["step"]``, the aspect
contrastive (NRC) loss and the topic orthogonality penalty. The per-window
masked softmax pooling telescopes into cumulative sums, as in ComiRec.

As in the JAX package, evaluation reads the user at the last position
L − 1, not at ``seq_len − 1`` (the reference's gather there hits a pad slot
of a left-padded history, dualvae.py:458-466). Computes in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from mhrec_tpu_torch.models.layers import (
    ItemEmbed,
    LayerNorm,
    batch_rows,
    cosine_normalize,
    dropout,
    trunc_normal_init,
    xavier_uniform_init,
)
from mhrec_tpu_torch.models.losses import (
    clamp_logit_scale,
    gathered_pool,
    global_count,
    logit_scale_param,
)
from mhrec_tpu_torch.utils.enums import InputType

EPS = 1e-10
_MIN = torch.finfo(torch.float32).min

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "silu": nn.functional.silu,
         "relu": torch.relu}


def causal_masked_pooling(scores, values, mask):
    """Per-position causal masked-softmax pooling through cumulative sums.

    scores: [B, L, A]; values: [B, L, A, K]; mask: [B, L] bool. Returns
    pooled [B, L, A, K], where entry l pools over valid j ≤ l."""
    s = scores.float()
    m = torch.where(mask[..., None], s, float("-inf")).amax(dim=1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask[..., None], torch.exp(s - m), torch.zeros_like(s))
    S1 = torch.cumsum(e, dim=1)
    num = torch.cumsum(e[..., None] * values.float(), dim=1)
    return torch.where(S1[..., None] > 0, num / torch.clamp(S1, min=1e-20)[..., None],
                       torch.zeros_like(num))


class DualVAE(nn.Module):
    input_type = InputType.SEQ
    medusa_num_heads = 1

    def __init__(self, item_num: int, embedding_dim: int, max_seq_length: int,
                 latent_dim: int = 32, num_aspects: int = 5, encoder_structure=(64,),
                 act_fn: str = "tanh", dropout_rate: float = 0.2,
                 latent_dropout_rate: float = 0.2, target_beta_kl: float = 0.01,
                 kl_anneal_steps: int = 10000, gama_cl: float = 0.01, cl_temp: float = 0.2,
                 aspect_temperature: float = 0.5, ortho_lambda: float = 0.1,
                 fix_temp: bool = False):
        super().__init__()
        A, K, D = num_aspects, latent_dim, embedding_dim
        self.item_num = item_num
        self.num_aspects, self.latent_dim = A, K
        self.act = _ACTS.get(act_fn, torch.tanh)
        self.dropout_rate = dropout_rate
        self.latent_dropout_rate = latent_dropout_rate
        self.target_beta_kl = target_beta_kl
        self.kl_anneal_steps = kl_anneal_steps
        self.gama_cl = gama_cl
        self.cl_temp = cl_temp
        self.aspect_temperature = aspect_temperature
        self.ortho_lambda = ortho_lambda
        self.fix_temp = fix_temp
        self.item_embedding = ItemEmbed(item_num, D)
        self.position_embedding = nn.Embedding(max_seq_length, D)
        self.input_layernorm = LayerNorm(D, eps=1e-12)
        self.item_proj = nn.Linear(D, K * A)
        self.item_topics = nn.Parameter(torch.empty(A, K))
        hidden = max(16, K // 2)
        self.pool_hidden = nn.Linear(K, hidden)
        self.pool_out = nn.Linear(hidden, 1, bias=False)
        widths = (K,) + tuple(encoder_structure)
        self.inf_fc = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.inf_ln = nn.ModuleList(LayerNorm(w, eps=1e-12) for w in widths[1:])
        self.user_mu = nn.Linear(widths[-1], K)
        self.user_std = nn.Linear(widths[-1], K)
        logit_scale_param(self, fix_temp, math.log(1 / 0.05))
        # the data-parallel group (a DataMesh) in a process group: the
        # shared negatives are the global pool, the masked means divide by
        # global counts, the parameter-only terms by W and the random draws
        # cover the global batch
        self.mesh = None

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        """The JAX model's initialisers: truncated normal 0.02 on the tables
        and the aspect projection (bias too), uniform ±sqrt(1/K) topics,
        xavier-uniform kernels with zero biases elsewhere, unit LayerNorms."""
        for t in (self.item_embedding.weight, self.position_embedding.weight,
                  self.item_proj.weight, self.item_proj.bias):
            trunc_normal_init(t, gen)
        bound = math.sqrt(1.0 / self.latent_dim)
        self.item_topics.uniform_(-bound, bound, generator=gen)
        for lin in (self.pool_hidden, self.pool_out, *self.inf_fc, self.user_mu,
                    self.user_std):
            xavier_uniform_init(lin.weight, gen)
            if lin.bias is not None:
                lin.bias.zero_()
        for ln in (self.input_layernorm, *self.inf_ln):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        if not self.fix_temp:
            self.logit_scale.fill_(math.log(1 / 0.05))

    # ------------------------------------------------------------------
    def _embed(self, ids, sub=None):
        # a bf16 table's rows are read in float32
        return self.item_embedding(ids, sub).float()

    def _process_sequence(self, seq_items, sub=None, generator=None):
        L = seq_items.shape[1]
        x = self._embed(seq_items, sub) + self.position_embedding.weight[:L][None]
        return dropout(self.input_layernorm(x), self.dropout_rate, generator, self.mesh)

    def _disentangle(self, embs):
        proj = self.item_proj(embs)
        return proj.reshape(*proj.shape[:-1], self.num_aspects, self.latent_dim)

    def _aspect_probs(self, dis_embs):
        sim = torch.einsum("...ak,ak->...a", cosine_normalize(dis_embs),
                           cosine_normalize(self.item_topics))
        return torch.softmax(sim / self.aspect_temperature, dim=-1)

    def _infer_causal(self, input_seq_embs, seq_mask, generator=None):
        """Causal user latents (z [B, L, A, K], kl [B, L, A]). With a
        generator (training): dropout and z = μ + ε·σ, ε from it; without
        one, z = μ."""
        dis = self._disentangle(input_seq_embs)                       # [B, L, A, K]
        filtered = dis * self._aspect_probs(dis)[..., None]
        mesh = self.mesh
        h = dropout(self.act(self.pool_hidden(filtered)), self.dropout_rate, generator, mesh)
        scores = self.pool_out(h).squeeze(-1)                         # [B, L, A]
        h = causal_masked_pooling(scores, filtered, seq_mask)         # [B, L, A, K]
        for fc, ln in zip(self.inf_fc, self.inf_ln):
            h = dropout(self.act(ln(fc(h))), self.dropout_rate, generator, mesh)
        mu = self.user_mu(h)
        # jax.nn.softplus = logaddexp(x, 0)
        std = torch.logaddexp(self.user_std(h), torch.zeros((), device=h.device)) + 1e-4
        kl = (-0.5 * (1 + 2.0 * torch.log(std + EPS) - mu ** 2 - std ** 2)).sum(dim=-1)
        if generator is None:
            return mu, kl
        eps = batch_rows(mu.shape, mesh, lambda shape: torch.randn(
            shape, generator=generator, device=mu.device))
        return dropout(mu + eps * std, self.latent_dropout_rate, generator, mesh), kl

    # ------------------------------------------------------------------
    def forward(self, batch, sub=None, generator=None):
        """Training forward (JAX ``DualVAE.__call__``); ``batch["step"]``
        (the trainer's step) anneals the KL weight."""
        items = batch["items"]
        user_mask = batch["masked_index"].bool()
        L = self.position_embedding.weight.shape[0]
        step = batch.get("step", self.kl_anneal_steps)
        if self.kl_anneal_steps > 0:
            ramp = torch.tensor(float(step + 1), dtype=torch.float32) / self.kl_anneal_steps
            beta_kl = self.target_beta_kl * torch.clamp(ramp, max=1.0).to(items.device)
        else:
            beta_kl = torch.tensor(self.target_beta_kl, dtype=torch.float32,
                                   device=items.device)

        seq_mask = user_mask[:, :L]
        seq_items = torch.where(seq_mask, items[:, :L], torch.zeros_like(items[:, :L]))
        target_mask = user_mask[:, 1: L + 1] & seq_mask
        x = self._process_sequence(seq_items, sub, generator)
        z, kl = self._infer_causal(x, seq_mask, generator)

        mesh = self.mesh
        world = 1 if mesh is None else mesh.world
        tm = target_mask.float()
        n_tok = global_count(tm.sum(), mesh)  # the global batch's valid tokens
        A = self.num_aspects
        kl_loss = (kl * tm[..., None]).sum() / (n_tok * A + EPS)

        pos_dis = self._disentangle(self._embed(items[:, 1: L + 1], sub))     # [B, L, A, K]
        pos_probs = self._aspect_probs(pos_dis)
        neg_dis = self._disentangle(self._embed(batch["neg_items"][:, -1].reshape(-1), sub))
        # the global batch's shared pool: each rank's rows disentangled and
        # weighted by their own, then gathered (gradient summed over ranks)
        N, K = neg_dis.shape[0], self.latent_dim
        neg_probs = gathered_pool(self._aspect_probs(neg_dis), mesh)         # [N, A]
        neg_n = gathered_pool(cosine_normalize(neg_dis).reshape(N, A * K), mesh).reshape(
            -1, A, K)

        z_n, pos_n = (cosine_normalize(t) for t in (z, pos_dis))
        pos_logits = (torch.einsum("blak,blak->bla", z_n, pos_n) * pos_probs).sum(-1)[..., None]
        neg_logits = (torch.einsum("blak,nak->blna", z_n, neg_n)
                      * neg_probs[None, None]).sum(-1)                        # [B, L, N]

        scale = clamp_logit_scale(self.logit_scale)
        logits = torch.cat([pos_logits, neg_logits], dim=-1) * scale
        ce = torch.logsumexp(logits, dim=-1) - logits[..., 0]
        cnt = torch.clamp(n_tok, min=1.0)
        nce_loss = (ce * tm).sum() / cnt
        cl_loss = self._contrast_loss(z_n, pos_n, tm, n_tok)
        # the ranks' gradients are summed: a term of the parameters alone is
        # each rank's 1/W share, as is every batch-independent scalar
        ortho = self._ortho_loss() / world

        total = (nce_loss + beta_kl * kl_loss + self.gama_cl * cl_loss
                 + self.ortho_lambda * ortho)
        model_out = {
            "loss": total,
            "kl_loss": (beta_kl * kl_loss).detach(),
            "cl_loss": (self.gama_cl * cl_loss).detach(),
            "ortho_loss": (self.ortho_lambda * ortho).detach(),
            "current_beta_kl": beta_kl / world,
            "nce_samples": torch.tensor(float(logits.shape[-1]) / world, device=items.device),
        }
        beaten = (neg_logits * scale > pos_logits * scale).sum(-1)
        for kk in (1, 5, 10, 50, 100):
            if kk > logits.shape[-1]:
                break
            model_out[f"nce_top{kk}_acc"] = (((beaten < kk).float() * tm).sum() / cnt).detach()
        return model_out

    def _contrast_loss(self, z_n, pos_n, tm, n_tok):
        """NRC aspect contrastive loss over valid tokens (dualvae.py:209-228),
        a fixed-shape masked mean; ``n_tok`` the global batch's count of
        valid tokens."""
        A = self.num_aspects
        pos_score = torch.exp(torch.einsum("blak,blak->bla", pos_n, z_n) / self.cl_temp)
        acl = torch.einsum("blak,blck->blac", pos_n, z_n)  # target aspect a vs user aspect c
        eye = torch.eye(A, dtype=torch.bool, device=acl.device)
        acl = torch.where(eye, _MIN, acl)
        neg_score = torch.exp(acl / self.cl_temp).sum(-1)  # [B, L, A]
        token_loss = -torch.log(pos_score / (neg_score + EPS))
        cnt = torch.clamp(n_tok * A, min=1.0)
        return (token_loss * tm[..., None]).sum() / cnt

    def _ortho_loss(self):
        t = cosine_normalize(self.item_topics)
        eye = torch.eye(self.num_aspects, device=t.device)
        return torch.linalg.norm(t @ t.t() - eye, ord="fro")

    # ------------------------------------------------------------------
    def predict_embeddings(self, item_seq, target_tags=None):
        z, _ = self._infer_causal(self._process_sequence(item_seq), item_seq != 0)
        combined = cosine_normalize(z[:, -1]).reshape(item_seq.shape[0], -1)  # [B, A·K]
        return {"head_embs": combined[:, None, :], "user_emb": combined}

    def score_items(self, head_embs, item_feats, item_tags, target_tags, switch_pred):
        return torch.matmul(head_embs, item_feats.t()) * clamp_logit_scale(self.logit_scale)

    def compute_item_all(self):
        dis = self._disentangle(self._embed(
            torch.arange(self.item_num, device=self.item_embedding.weight.device)))
        weighted = cosine_normalize(dis) * self._aspect_probs(dis)[..., None]
        return weighted.reshape(self.item_num, -1)


def dualvae_from_config(config, dataload) -> DualVAE:
    size = config.get("vae_encoder_structure_size", "small")
    structure = {"large": (256, 128, 64), "medium": (128, 64)}.get(size, (64,))
    return DualVAE(
        item_num=dataload.item_num,
        embedding_dim=config["item_embedding_size"],
        max_seq_length=config["MAX_ITEM_LIST_LENGTH"],
        latent_dim=config.get("vae_latent_dim", 32),
        num_aspects=config.get("vae_num_aspects", 5),
        encoder_structure=structure,
        act_fn=config.get("vae_act_fn", "tanh"),
        dropout_rate=config.get("hidden_dropout_prob", 0.2) or 0.2,
        latent_dropout_rate=config.get("vae_latent_dropout", 0.2),
        target_beta_kl=config.get("vae_beta_kl", 0.1),
        kl_anneal_steps=config.get("vae_kl_anneal_steps", 10000),
        gama_cl=config.get("vae_gama_cl", 0.01),
        aspect_temperature=config.get("vae_aspect_temperature", 0.5),
        ortho_lambda=config.get("vae_ortho_lambda", 0.1),
        fix_temp=bool(config["fix_temp"]),
    )
