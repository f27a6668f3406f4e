"""The repo's end-to-end experiment (``demo/``) through the port: stand-in
data, MagicPoint, NeRF scenes, both supervision arms and their scores.
``python -m spnerf_tpu_torch.demo.run [leg]`` drives it (see ``run.py``)."""
