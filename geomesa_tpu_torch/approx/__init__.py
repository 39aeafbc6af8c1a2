"""geomesa_tpu_torch.approx — the serve layer's exact result cache.

`ResultCache` keys count/execute results on (typeName, canonical CQL,
hints, manifest version), so invalidation is exact by construction. The
sketch answer engine and its sketches (the approximate tier) come with
ROADMAP A4.
"""

from geomesa_tpu_torch.approx.cache import ResultCache, result_key

__all__ = ["ResultCache", "result_key"]
