"""User tools, each run as ``python -m mobile_slam_tpu_torch.tools.<name>``:
offline ATE / RPE of a run directory (``compare_trajectories``) and the
browser replay dataset (``export_replay_dataset``), the counterparts of the
repo's ``scripts/evaluation/compare_trajectories.py`` and
``scripts/export_replay_dataset.py``. Neither needs JAX or OpenCV."""
