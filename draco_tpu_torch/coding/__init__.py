"""The cyclic gradient code and its small linear algebra
(draco_tpu/coding)."""
