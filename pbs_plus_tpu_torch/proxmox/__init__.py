"""Proxmox formats the port needs: the task UPID (``upid``, a copy)."""
