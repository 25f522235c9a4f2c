"""Version / bundle metadata (copy of gie_tpu/version.py).

Mirrors reference version/version.go and the CRD bundle-version annotation
`inference.networking.k8s.io/bundle-version` (reference pkg/generator/main.go:35-106).
"""

__version__ = "0.1.0"

# Stamped into generated CRDs and the conformance report, like the reference's
# bundle-version annotation.
BUNDLE_VERSION = "v0.1.0-tpu"

BUNDLE_VERSION_ANNOTATION = "inference.networking.k8s.io/bundle-version"
