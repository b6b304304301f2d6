"""The RAG document store served over REST (``serve.py``)."""
