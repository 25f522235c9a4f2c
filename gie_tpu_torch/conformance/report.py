"""Versioned conformance-report emission (copy of conformance/report.py;
reference conformance/conformancereport.go:32-56 + reports/ directory
convention)."""

from __future__ import annotations

import dataclasses
import datetime

import yaml

from gie_tpu_torch.version import BUNDLE_VERSION


@dataclasses.dataclass
class TestResult:
    short_name: str
    passed: bool


@dataclasses.dataclass
class ConformanceReport:
    implementation: str = "gie-tpu"
    implementation_version: str = BUNDLE_VERSION
    gateway_api_inference_extension_version: str = BUNDLE_VERSION
    profile: str = "Gateway"
    # Honesty marker: this suite runs against conformance/harness.py's
    # in-process model of the gateway/Envoy data plane, not a real deployed
    # gateway. The EPP under test is real (datastore, reconcilers,
    # scheduler, wire-exact ext-proc protos); the proxy and cluster are
    # simulated. A report from a real-gateway run would say "gateway".
    mode: str = "in-process-harness"
    results: list[TestResult] = dataclasses.field(default_factory=list)

    def add(self, short_name: str, passed: bool) -> None:
        self.results.append(TestResult(short_name, passed))

    def to_yaml(self) -> str:
        passed = [r.short_name for r in self.results if r.passed]
        failed = [r.short_name for r in self.results if not r.passed]
        doc = {
            "apiVersion": "gateway.networking.k8s.io/v1alpha1",
            "kind": "ConformanceReport",
            "date": datetime.datetime.now(datetime.timezone.utc).isoformat(),
            "implementation": {
                "organization": "gie-tpu",
                "project": self.implementation,
                "version": self.implementation_version,
            },
            # The data plane these results were earned against: an
            # in-process harness (simulated proxy + cluster, real EPP),
            # NOT a really-deployed gateway. See conformance/harness.py.
            "mode": self.mode,
            "gatewayAPIInferenceExtensionVersion": (
                self.gateway_api_inference_extension_version
            ),
            "profiles": [
                {
                    "name": self.profile,
                    "core": {
                        "result": "success" if not failed else "failure",
                        "statistics": {
                            "Passed": len(passed),
                            "Failed": len(failed),
                        },
                        "passedTests": sorted(passed),
                        "failedTests": sorted(failed),
                    },
                }
            ],
        }
        return yaml.safe_dump(doc, sort_keys=False)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_yaml())
