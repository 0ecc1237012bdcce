"""Entry points of the port: the DiT serving path of ``launch/serve.py``,
the DiT trainer ``launch/train.py`` and its step builders
``launch/steps.py``."""
