"""The reference CLIs of the ported methods: `python -m tpuflow_torch.cli.<name>`."""
