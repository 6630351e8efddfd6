"""Offline (batch) preprocessing: windowed CTR-rate features + downsampling
(the port's copy of the JAX package's ``offline/``).

Python core (ctr_features.py) shared by the PySpark driver (spark_job.py, for
HDFS/YARN scale) and the local driver (local_job.py, for small data and
tests) — the reference's python/spark/data_process.py + its local test.
No device code.
"""
