"""parallel of the torch port: data parallelism over ranks (``dp.py``)."""
