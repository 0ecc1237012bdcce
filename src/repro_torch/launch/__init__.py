"""Entry points of the port (the DiT serving path of ``launch/serve.py``)."""
