"""The system under test, one module a family of configurations: each
builds, from a configuration and the seed's acquisition, the port's models,
geometries, observed data and objective as the port's Marmousi drivers do
(``devito_fwi_tpu_torch.drivers._marmousi_common``), and names the port's
counters of calls that left the kernel route."""
