"""Serving API: load once, answer (head, relation) -> top-k tail queries.

Counterpart of ``ultra_tpu/serve.py``. Relation representations for all R
query relations are computed once per graph; each batch of requests is then
one EntityNBFNet pass plus top-k.

    predictor = UltraPredictor.from_checkpoint("ultra_3g.pth", split)
    scores, tails = predictor.predict_tails(h=[14, 99], r=[3, 7], k=10)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ultra_tpu_torch.graph import Graph, resolve_device
from ultra_tpu_torch.models.nbfnet import Ultra, UltraConfig, entity_nbfnet_score_all
from ultra_tpu_torch.train.eval import precompute_relation_representations


class UltraPredictor:
    """(h, r) -> top-k tail predictor on one device."""

    def __init__(self, model: Ultra, graph: Graph, batch_size: int = 8, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.graph = graph.to(self.device)
        self.batch_size = batch_size
        self.rel_reprs = precompute_relation_representations(self.model, self.graph)

    @classmethod
    def from_checkpoint(
        cls, ckpt_path: str, split, cfg: Optional[UltraConfig] = None,
        device="cuda", **kw,
    ) -> "UltraPredictor":
        """Load a reference-layout ``.pth`` and serve ``split``'s graph."""
        from ultra_tpu_torch.data.kg import split_to_graph
        from ultra_tpu_torch.utils.torch_ckpt import load_ultra_checkpoint

        model = Ultra(cfg or UltraConfig())
        model.load_state_dict(load_ultra_checkpoint(ckpt_path))
        return cls(model, split_to_graph(split, device=device), device=device, **kw)

    @torch.no_grad()
    def _score_batch(self, h: np.ndarray, r: np.ndarray) -> torch.Tensor:
        """(batch_size, V) logits; short batches are padded with id 0."""
        pad = self.batch_size - len(h)
        h = torch.from_numpy(np.pad(h, (0, pad))).to(self.device)
        r = torch.from_numpy(np.pad(r, (0, pad))).to(self.device)
        return entity_nbfnet_score_all(
            self.model.entity_model, self.graph, self.rel_reprs[r], h, r
        )

    def _batches(self, h: Sequence[int], r: Sequence[int]):
        h = np.asarray(h, dtype=np.int64)
        r = np.asarray(r, dtype=np.int64)
        if h.shape != r.shape or h.ndim != 1:
            raise ValueError(f"h and r must be 1-D of one length, got {h.shape}, {r.shape}")
        for start in range(0, len(h), self.batch_size):
            hb, rb = h[start:start + self.batch_size], r[start:start + self.batch_size]
            yield len(hb), self._score_batch(hb, rb)

    def predict_tails(self, h: Sequence[int], r: Sequence[int], k: int = 10):
        """(scores (N, k), tail ids (N, k)) as numpy arrays."""
        out_s, out_i = [], []
        for n, scores in self._batches(h, r):
            top_s, top_i = torch.topk(scores[:n], k, dim=-1)
            out_s.append(top_s.cpu().numpy())
            out_i.append(top_i.cpu().numpy())
        return np.concatenate(out_s), np.concatenate(out_i)

    def predict_heads(self, t: Sequence[int], r: Sequence[int], k: int = 10):
        """Head prediction through the inverse relation r + R/2."""
        r = np.asarray(r, dtype=np.int64)
        return self.predict_tails(t, r + self.graph.num_relations // 2, k=k)

    def score_all(self, h: Sequence[int], r: Sequence[int]) -> np.ndarray:
        """(N, V) raw logits over every candidate tail."""
        return np.concatenate(
            [scores[:n].cpu().numpy() for n, scores in self._batches(h, r)]
        )
