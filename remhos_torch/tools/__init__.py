"""Developer measurement tools of the port, run as modules
(`python -m remhos_torch.tools.microbench`, `... .kernelbench`)."""
