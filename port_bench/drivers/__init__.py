"""Drivers, one a traffic kind (a mix's ``kind``): ``eval_stream``."""
