"""Vocabulary pieces the serving path needs (``data/vocab.py``,
``data/synthetic.py``)."""
