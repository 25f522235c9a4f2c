"""CRD YAML generation (reference pkg/generator/main.go:35-106)
(copy of gie_tpu/api/crdgen.py).

Emits installable CustomResourceDefinition manifests for InferencePool v1
and InferencePoolImport v1alpha1, with the structural schema + the CEL
rules the Python validators enforce (targetPorts uniqueness,
port-required-when-Service), stamped with the bundle-version annotation
exactly like the reference generator.
"""

from __future__ import annotations

import os

import yaml

from gie_tpu_torch.api.types import GROUP, GROUP_X
from gie_tpu_torch.version import BUNDLE_VERSION, BUNDLE_VERSION_ANNOTATION


def _condition_schema() -> dict:
    return {
        "type": "object",
        "required": ["type", "status"],
        "properties": {
            "type": {"type": "string"},
            "status": {"type": "string", "enum": ["True", "False", "Unknown"]},
            "reason": {"type": "string"},
            "message": {"type": "string"},
            "observedGeneration": {"type": "integer"},
            "lastTransitionTime": {"type": "string"},
        },
    }


def _parent_status_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "parentRef": {
                "type": "object",
                "required": ["name"],
                "properties": {
                    "group": {"type": "string",
                              "default": "gateway.networking.k8s.io"},
                    "kind": {"type": "string", "default": "Gateway"},
                    "name": {"type": "string"},
                    "namespace": {"type": "string"},
                },
            },
            "conditions": {
                "type": "array",
                "maxItems": 8,
                "items": _condition_schema(),
            },
        },
    }


def inferencepool_crd() -> dict:
    """reference config/crd/bases/inference.networking.k8s.io_inferencepools.yaml."""
    spec_schema = {
        "type": "object",
        "required": ["selector", "targetPorts"],
        "properties": {
            "selector": {
                "type": "object",
                "properties": {
                    "matchLabels": {
                        "type": "object",
                        "additionalProperties": {"type": "string"},
                    }
                },
            },
            "targetPorts": {
                "type": "array",
                "minItems": 1,
                "maxItems": 8,
                # reference inferencepool_types.go:78
                "x-kubernetes-validations": [
                    {
                        "message": "port number must be unique",
                        "rule": "self.all(p1, self.exists_one(p2, "
                                "p1.number==p2.number))",
                    }
                ],
                "items": {
                    "type": "object",
                    "properties": {
                        "number": {
                            "type": "integer",
                            "minimum": 1,
                            "maximum": 65535,
                        }
                    },
                },
            },
            "appProtocol": {
                "type": "string",
                "enum": ["http", "kubernetes.io/h2c"],
                "default": "http",
            },
            "endpointPickerRef": {
                "type": "object",
                "required": ["name"],
                # reference inferencepool_types.go:128
                "x-kubernetes-validations": [
                    {
                        "message": "port is required when kind is 'Service' "
                                   "or unspecified (defaults to 'Service')",
                        "rule": "self.kind != 'Service' || has(self.port)",
                    }
                ],
                "properties": {
                    "group": {"type": "string", "default": ""},
                    "kind": {"type": "string", "default": "Service"},
                    "name": {"type": "string"},
                    "port": {
                        "type": "object",
                        "properties": {
                            "number": {
                                "type": "integer",
                                "minimum": 1,
                                "maximum": 65535,
                            }
                        },
                    },
                    "failureMode": {
                        "type": "string",
                        "enum": ["FailOpen", "FailClose"],
                        "default": "FailClose",
                    },
                },
            },
        },
    }
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {
            "name": f"inferencepools.{GROUP}",
            "annotations": {BUNDLE_VERSION_ANNOTATION: BUNDLE_VERSION},
        },
        "spec": {
            "group": GROUP,
            "names": {
                "kind": "InferencePool",
                "listKind": "InferencePoolList",
                "plural": "inferencepools",
                "singular": "inferencepool",
                "shortNames": ["infpool"],
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": "v1",
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}},
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "spec": spec_schema,
                                "status": {
                                    "type": "object",
                                    "properties": {
                                        "parents": {
                                            "type": "array",
                                            "maxItems": 32,
                                            "items": _parent_status_schema(),
                                        }
                                    },
                                },
                            },
                        }
                    },
                }
            ],
        },
    }


def inferencepoolimport_crd() -> dict:
    """reference apix/v1alpha1 CRD."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {
            "name": f"inferencepoolimports.{GROUP_X}",
            "annotations": {BUNDLE_VERSION_ANNOTATION: BUNDLE_VERSION},
        },
        "spec": {
            "group": GROUP_X,
            "names": {
                "kind": "InferencePoolImport",
                "listKind": "InferencePoolImportList",
                "plural": "inferencepoolimports",
                "singular": "inferencepoolimport",
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": "v1alpha1",
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}},
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "status": {
                                    "type": "object",
                                    "properties": {
                                        "controllers": {
                                            "type": "array",
                                            "items": {
                                                "type": "object",
                                                "properties": {
                                                    "name": {"type": "string"},
                                                    "exportingClusters": {
                                                        "type": "array",
                                                        "items": {
                                                            "type": "object",
                                                            "properties": {
                                                                "name": {
                                                                    "type": "string"
                                                                }
                                                            },
                                                        },
                                                    },
                                                    "parents": {
                                                        "type": "array",
                                                        "items": _parent_status_schema(),
                                                    },
                                                },
                                            },
                                        }
                                    },
                                }
                            },
                        }
                    },
                }
            ],
        },
    }


def _check_cel_rules(crd: dict) -> None:
    """Reject any x-kubernetes-validations rule outside the evaluator's
    supported CEL subset AT GENERATION TIME — an unsupported rule must
    fail the build, never ship in YAML and silently mis-evaluate at
    admission (the reference gets this guarantee from compiling rules
    against a real apiserver, test/cel/main_test.go:38-95)."""
    from gie_tpu_torch.api.cel import CelError, iter_rules, validate_rule_support

    for rule in iter_rules(crd):
        try:
            validate_rule_support(rule)
        except CelError as e:
            raise ValueError(
                f"CRD {crd['metadata']['name']} carries a rule outside "
                f"the supported CEL subset: {rule!r}: {e}") from e


def generate(out_dir: str) -> list[str]:
    """Write both CRDs to `<out_dir>/<group>_<plural>.yaml` (the reference
    generator's naming, generator/main.go:99)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for crd in (inferencepool_crd(), inferencepoolimport_crd()):
        _check_cel_rules(crd)
        group = crd["spec"]["group"]
        plural = crd["spec"]["names"]["plural"]
        path = os.path.join(out_dir, f"{group}_{plural}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(crd, f, sort_keys=False)
        written.append(path)
    return written


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "config/crd/bases"
    for p in generate(out):
        print(p)
