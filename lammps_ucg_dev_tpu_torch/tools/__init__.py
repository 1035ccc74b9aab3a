"""Measurement tools of the port (``python -m lammps_ucg_dev_tpu_torch.tools.<name>``)."""
