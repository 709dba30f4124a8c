"""Shared configuration and device selection."""
