"""InferencePool / InferencePoolImport API layer (the modules of
gie_tpu/api): typed objects and their validation (types), the objective
registry (objectives), CEL evaluation of the CRDs' rules (cel), the CRD
generator (crdgen), typed clients, informers and apply configurations
(client, informers, applyconfiguration), the Gateway API types of the
conformance tier (gateway) and InferenceModelRewrite (modelrewrite)."""
