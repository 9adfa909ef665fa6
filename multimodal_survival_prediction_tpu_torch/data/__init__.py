"""Cohort data of the port: NIfTI, matching table, RNA matrix, ingest."""
