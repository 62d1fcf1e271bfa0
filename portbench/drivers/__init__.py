"""Drivers, one a traffic kind (``traffic/<name>.json``'s ``kind``)."""
