"""The serving layer (port of ``spark_druid_olap_tpu/server/``): the HTTP SQL
endpoint (``http.py``) and the Arrow Flight facade (``flight.py``)."""
