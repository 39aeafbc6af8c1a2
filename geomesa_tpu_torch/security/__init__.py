"""Visibility security.

Parity: geomesa-security (AuthorizationsProvider SPI, VisibilityEvaluator
for Accumulo-style boolean visibility expressions like "admin&(usa|gbr)")
[upstream, unverified]. A copy of the reference package's `security/`.
Visibilities live in a dictionary-coded label column; a user's
authorizations give an allow table over the vocabulary, which the planner
gathers by code on the device (`plan.runner.visibility_mask`) and ANDs into
every predicate mask.
"""

from geomesa_tpu_torch.security.visibility import (
    VisibilityEvaluator,
    AuthorizationsProvider,
    StaticAuthorizationsProvider,
    allow_mask,
)

__all__ = [
    "VisibilityEvaluator",
    "AuthorizationsProvider",
    "StaticAuthorizationsProvider",
    "allow_mask",
]
